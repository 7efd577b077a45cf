"""Architecture configuration schema + input-shape sets.

One ArchConfig per assigned architecture (exact dims from the assignment
table); .reduced() yields a family-preserving small config for CPU smoke
tests. The four input-shape sets (train_4k / prefill_32k / decode_32k /
long_500k) are defined here with their applicability rules (DESIGN.md
SS5: long_500k only for sub-quadratic families).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Expert-count padding granularity: 16 = TP-axis EP (training);
    # serving cells may raise it to data*model (e.g. 256) for 2D expert
    # sharding, where weights stay resident and tokens are gathered
    # (EXPERIMENTS.md SSPerf hillclimb 3).
    pad_to: int = 16


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | audio | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # defaults to d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_kind: str = "rope"               # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    tie_embeddings: bool = False
    scale_embeddings: bool = False        # gemma: x *= sqrt(d_model)
    norm_eps: float = 1e-6
    act: str = "silu"
    # sliding-window pattern: window size + global-attention period
    # (every `global_every`-th layer is global; 0 = all global/full)
    sliding_window: int = 0
    global_every: int = 0
    global_rope_theta: Optional[float] = None
    # MoE / SSM / hybrid extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0            # zamba2: shared block period
    # encoder-decoder (whisper): encoder frames are stub embeddings
    enc_dec: bool = False
    n_frames: int = 1500
    n_enc_layers: int = 0
    # vlm stub frontend
    vision_tokens: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / mostly-sliding-window)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.global_every > 0)

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        pattern = max(self.global_every, self.shared_attn_every, 1)
        n_layers = max(2 * pattern, 2)
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv * 2, 4)
        moe = (MoEConfig(n_experts=8, top_k=2, d_ff_expert=32)
               if self.moe else None)
        ssm = (SSMConfig(d_state=16, expand=2, head_dim=16, chunk=16)
               if self.ssm else None)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=64, n_heads=heads,
            n_kv_heads=kv, d_head=16, d_ff=128, vocab=512,
            mrope_sections=(2, 3, 3),  # sums to d_head/2 = 8
            sliding_window=min(self.sliding_window, 32) if self.sliding_window
            else 0, moe=moe, ssm=ssm, n_frames=24,
            n_enc_layers=2 if self.enc_dec else 0, vision_tokens=8)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """Assignment rules: long_500k needs sub-quadratic attention;
    all archs in the pool have a decode path (whisper decodes with its
    decoder stack)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
