"""Hand-written CUDA kernels for the bulk-bitwise hot spots.

Each kernel module (``bitwise``, ``popcount``, ``bitweaving``) holds the
wrapper that launches its ``csrc/*.cu`` kernel beside the plain PyTorch
version of the same function; ``ref.py`` holds the oracles and
``ops.py`` the public wrappers. Nothing here builds or loads a kernel
at import time.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
