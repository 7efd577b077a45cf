"""Optimizer: AdamW with warmup+cosine schedule and global-norm
clipping."""

from . import optimizer
