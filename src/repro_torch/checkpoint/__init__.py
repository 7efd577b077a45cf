"""Async, atomic checkpointing in the reference's on-disk layout."""

from .checkpointing import Checkpointer
