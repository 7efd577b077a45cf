"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 - GQA, QKV bias. [hf:Qwen/Qwen2.5-3B]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936, d_head=128,
    qkv_bias=True, rope_theta=1_000_000.0,
)
