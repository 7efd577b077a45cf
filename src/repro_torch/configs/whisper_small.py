"""whisper-small [audio]: 12L d_model=768 12H d_ff=3072 vocab=51865 -
encoder-decoder; conv frontend is a STUB (input_specs provides precomputed
frame embeddings (B, 1500, d_model)). [arXiv:2212.04356]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865, d_head=64,
    rope_kind="none",  # whisper uses sinusoidal abs positions
    tie_embeddings=True,
    act="gelu", enc_dec=True, n_frames=1500, n_enc_layers=12,
)
