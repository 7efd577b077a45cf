"""The Star Schema Benchmark's flattened lineorder on the port: the
BitWeaving deployment over six columns of order-preserving codes (each
column drawn on the card, bit-sliced there into its planes; a query's
plan joins one ``predicate_plan`` a range by the spec's AND, OR and NOT
through ``compose``)."""

from .bitweaving import Deployment

__all__ = ["Deployment"]
