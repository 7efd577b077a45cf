"""Model zoo: every family of the reference (dense, MoE, VLM, SSM,
hybrid, encoder-decoder) as PyTorch stacks."""

from .model import Model, build_model
from .param import ParamDef, count_params, init_tree

__all__ = ["Model", "ParamDef", "build_model", "count_params", "init_tree"]
