"""Masked initialization (paper Section 8.4.2): bulk set/clear of bit
positions via preloaded mask rows - x|mask and x&~mask row-wide."""

from __future__ import annotations

import numpy as np

from ..core import BitVector, BulkBitwiseEngine


def masked_set(engine: BulkBitwiseEngine, x: BitVector,
               mask: BitVector) -> BitVector:
    return engine.masked_set(x, mask)


def masked_clear(engine: BulkBitwiseEngine, x: BitVector,
                 mask: BitVector) -> BitVector:
    return engine.masked_clear(x, mask)


def clear_color_channel(engine: BulkBitwiseEngine, image_bits: BitVector,
                        channel_mask: BitVector) -> BitVector:
    """The paper's graphics example: clear one color channel across a
    whole image buffer with a single bulk AND-NOT."""
    return engine.masked_clear(image_bits, channel_mask)
