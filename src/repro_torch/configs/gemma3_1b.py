"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 - 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense", n_layers=26, d_model=1152,
    n_heads=4, n_kv_heads=1, d_ff=6912, vocab=262144, d_head=256,
    rope_theta=10000.0, global_rope_theta=1_000_000.0,
    sliding_window=1024, global_every=6,  # layers 5,11,17,23 global (5:1)
    tie_embeddings=True, scale_embeddings=True, act="gelu",
)
