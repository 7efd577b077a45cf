"""The Star Schema Benchmark's flattened lineorder on the port: the
BitWeaving deployment over six columns of order-preserving codes (each
column drawn on the card, bit-sliced there into its planes; a query's
plan is ``predicate_plan`` over its ranges)."""

from .bitweaving import Deployment

__all__ = ["Deployment"]
