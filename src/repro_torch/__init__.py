"""PyTorch/CUDA port of the in-DRAM bulk bitwise execution engine.

Mirrors the layout of the JAX package ``repro``, which stays the
reference: each module here has its counterpart at the same path there.
Packed words are ``torch.int32`` tensors holding the reference's
``uint32`` bit patterns; the ``"cuda"`` backend runs the hand-written
kernels of ``repro_torch.kernels`` and ``"torch"`` plain tensor code.
"""
