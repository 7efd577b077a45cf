"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 - Mamba2 backbone + weight-tied shared attention
block invoked every 6 layers. [arXiv:2411.15242]"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, d_head=80,
    rope_theta=10000.0,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64),
    shared_attn_every=6,
)
