"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 - GQA. [arXiv:2403.17297]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544, d_head=128,
    rope_theta=1_000_000.0,
)
