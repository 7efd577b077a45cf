"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 - SSD (state-space duality). [arXiv:2405.21060]"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    d_head=64, rope_kind="none",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64),
)
