"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 - M-RoPE, dynamic resolution; ViT frontend is a STUB
(input_specs provides precomputed patch embeddings). [arXiv:2409.12191]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, d_head=128,
    qkv_bias=True, rope_kind="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0, vision_tokens=256,
)
