"""The port's dry-run analyses on one device against the reference's
compiled programs: for dense (gemma3-1b, qwen2.5-3b), MoE
(granite-moe-3b-a800m), SSM (mamba2-780m), hybrid (zamba2-2.7b),
encoder-decoder (whisper-small) and VLM (qwen2-vl-7b) archs at
``.reduced()``, each under train (``remat="save_attn"``), prefill and
decode at batch 4 x 64, the cell the reference's dry-run builds without
a mesh, compiled by ``jax.jit(...).lower(...).compile()`` on the CPU:

- ``flops_per_chip`` (``FlopCounterMode`` over the port's traced step)
  equals ``hloparse.dot_flops`` of the compiled HLO, exactly. One stated
  difference: XLA contracts the gradient of the SSD's two three-operand
  einsums with respect to their elementwise factor (the (b, c, q, h)
  decay of ``bcqh,bcqhn,bchpn->bcqhp`` and segment weights of
  ``bckh,bckhn,bckhp->bchpn``) over the state dimension n as a dot,
  where the port's autograd takes a product and a sum, which counts no
  FLOPs: so the reference's train FLOPs of an SSM layer are higher by
  exactly 2 * (2 * b * c * q * h * n) (mamba2 and zamba2);
- ``argument_size_bytes`` equals the compiled program's
  ``memory_analysis().argument_size_in_bytes``, exactly, with
  ``keep_unused=True``: by default ``jax.jit`` drops the arguments a
  step never reads (whisper's decode reads no encoder weight, mamba2's
  no ``pos``), which the port's step is handed all the same;
- ``bytes_per_chip`` (every kernel-launching op's inputs plus outputs)
  is at or above ``hloparse.traffic_bytes`` (its ideal-fusion model) in
  train and prefill, where the eager stream writes and reads back every
  intermediate that model fuses away. In decode, which reads little but
  the weights and caches, it is held above half of it: the CPU program
  feeds its bf16 products through f32 copies of their operands
  (``convert`` fusions), so ``traffic_bytes`` reads a bf16 weight at
  twice its size (``hloparse``'s residual bias) where the port reads it
  once in bf16. The ratio is printed.
"""

import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.launch.hloparse import dot_flops, traffic_bytes
from repro.models import build_model as ref_build
from repro.optim.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.train.step import make_train_step as ref_train_step
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun

ARCHS = ("gemma3-1b", "qwen2.5-3b", "granite-moe-3b-a800m", "mamba2-780m",
         "zamba2-2.7b", "whisper-small", "qwen2-vl-7b")
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 4, 64


def _reference(arch, kind):
    """(dot FLOPs, traffic bytes, argument bytes) of the reference's
    compiled one-device cell."""
    cfg = ref_config(arch).reduced()
    model = ref_build(cfg)
    sds = jax.ShapeDtypeStruct
    i32 = jnp.int32
    b, s = BATCH, SEQ
    if kind == "train":
        batch = {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
    elif kind == "prefill":
        batch = {"tokens": sds((b, s), i32)}
    else:
        batch = {"tokens": sds((b, 1), i32), "pos": sds((b,), i32)}
    if cfg.family == "vlm" and kind != "decode":
        batch["vision_embeds"] = sds((b, cfg.vision_tokens, cfg.d_model),
                                     jnp.bfloat16)
        batch["vision_positions"] = sds((b, cfg.vision_tokens), i32)
        batch["mrope_positions"] = sds((3, b, s), i32)
    if cfg.enc_dec and kind != "decode":
        batch["frames"] = sds((b, cfg.n_frames, cfg.d_model), jnp.bfloat16)
    if kind == "train":
        fn = ref_train_step(model, RefOptimizerConfig(), remat="save_attn")
        ps = model.param_shapes()
        args = ({"params": ps, "opt": {"m": ps, "v": ps,
                                       "step": sds((), i32)}}, batch)
    elif kind == "prefill":
        def fn(p, bb):
            return model.prefill(p, bb, skv=s)
        args = (model.param_shapes(dtype=jnp.bfloat16), batch)
    else:
        def fn(p, c, bb):
            return model.decode_step(p, c, bb)
        args = (model.param_shapes(dtype=jnp.bfloat16),
                model.cache_shapes(b, s), batch)
    compiled = jax.jit(fn, keep_unused=True).lower(*args).compile()
    hlo = compiled.as_text()
    return (dot_flops(hlo), traffic_bytes(hlo),
            compiled.memory_analysis().argument_size_in_bytes)


def _ssd_gradient_dots(cfg) -> float:
    """The FLOPs of the dots XLA adds to an SSM train step (the module
    docstring): two a layer."""
    if cfg.ssm is None:
        return 0.0
    c = SEQ // cfg.ssm.chunk
    heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    per = 2.0 * BATCH * c * cfg.ssm.chunk * heads * cfg.ssm.d_state
    return cfg.n_layers * 2 * per


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_analyses_match_compiled_reference(arch, kind):
    flops, traffic, arg_bytes = _reference(arch, kind)
    cfg = get_config(arch).reduced()
    got = dryrun.analyse_cell(cfg, ShapeConfig(kind, SEQ, BATCH, kind),
                              None, torch.device("cpu"))
    extra = _ssd_gradient_dots(cfg) if kind == "train" else 0.0
    print(f"{arch} {kind}: flops {got['flops_per_chip']} vs reference "
          f"{flops} (+{extra} SSD gradient dots); bytes "
          f"{got['bytes_per_chip']} vs reference {traffic} (x"
          f"{got['bytes_per_chip'] / traffic:.2f}); argument bytes "
          f"{got['memory_analysis']['argument_size_bytes']}")
    assert got["flops_per_chip"] + extra == flops
    assert got["memory_analysis"]["argument_size_bytes"] == arg_bytes
    assert got["bytes_per_chip"] >= (traffic / 2 if kind == "decode"
                                     else traffic)
