"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU, against
the reference's (``repro.launch.dryrun``) and against real gloo ranks.

- The cell's data, exactly, for every applicable (arch, shape) of
  ``SHAPES`` on both production meshes: ``sharding_rules_for`` (with and
  without the 2-D EP override), ``input_specs``'s shapes and dtypes,
  ``batch_spec``, ``build_cell``'s parameter, cache and batch specs (the
  experts padded to data*model on the 2-D EP cells) and ``model_flops``
  from each package's ``n_active_params``. The reference's side runs in
  a subprocess (``JAX_PLATFORMS=cpu``; importing its module sets its
  512-device flag there). The port builds each cell's arguments under
  ``fake_mode`` on a fake group of the mesh's size, and each is its
  spec's shard.
- The (2,4) mesh on a fake 8-rank group, at ``.reduced()`` and batch 4 x
  64: FLOPs a rank within 10% of the reference's per-device
  ``dot_flops`` of its (2,4) compile (dense archs; both split the rows
  over "data" and the heads, the FFN and the vocabulary over "model");
  the argument bytes equal the reference's per-device
  ``argument_size_in_bytes`` of it (a subprocess on 8 host devices with
  ``test_torch_distributed.AUTO_AXES``; compiled with
  ``keep_unused=True``, as the port's step holds every argument it is
  given); the reference's collective kinds and bytes are printed beside
  the port's (GSPMD picks its own collectives). ``Model.forward(mesh=)``
  moves exactly the bytes the spec tree predicts: each leaf all-gathered
  over "data" alone, one all-reduce over "model" a sublayer, no
  logits.
- Fake equals real: the fake group's collective kinds, counts and bytes,
  its FLOPs, traffic and memory equal those of the same steps on 8 real
  gloo ranks (``tests/torch_dist_ranks.py dryrun8``).
- The CLI at full size (gemma3-1b ``train_4k`` on the fake 256-rank
  mesh) writes the JSON that ``benchmarks/roofline.py`` renders
  unchanged, and refuses a real process group.

The one-device analyses against the reference's compiled programs are in
``tests/test_torch_dryrun_compiled.py``.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

import torch_dist_ranks as ranks
from repro_torch.configs import REGISTRY, SHAPES, get_config, \
    shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (PRODUCTION_MESHES, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.models.param import ShardingRules, placements, tree_leaves
from repro_torch.models.sharding_ctx import axis_rules, spec_map
from test_torch_distributed import AUTO_AXES

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
HELPER = os.path.join(os.path.dirname(__file__), "torch_dist_ranks.py")
TIMEOUT = 900
CPU = torch.device("cpu")
CELLS = [(arch, name) for arch in sorted(REGISTRY)
         for name, shape in SHAPES.items()
         if shape_applicable(get_config(arch), shape)]
# the cells whose (2,4) FLOPs split evenly over "data": all but MoE
SPLIT_CELLS = [c for c in ranks.DRYRUN_CELLS if "moe" not in c[0]]

REFERENCE_CELLS = """
import json, sys
from repro.configs import REGISTRY, SHAPES, get_config, shape_applicable
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh, mesh_shape_dict
from repro.models import build_model


def spec(s):
    return [list(p) if isinstance(p, tuple) else p for p in s]


def tree(t):
    if isinstance(t, dict):
        return {k: tree(v) for k, v in t.items()}
    return spec(getattr(t, "spec", t))


out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    ms = mesh_shape_dict(mesh)
    for arch in sorted(REGISTRY):
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape):
                continue
            b, s = shape.global_batch, shape.seq_len
            ep2d = (shape.kind == "decode" and cfg.moe is not None
                    and cfg.moe.n_experts >= 64)
            rules = dryrun.sharding_rules_for(name, b, ms, ep2d=ep2d)
            batch = dryrun.input_specs(arch, name)
            _, _, shardings = dryrun.build_cell(arch, name, mesh)
            # run_cell's MODEL_FLOPS, from the unpadded model
            model = build_model(cfg)
            n_active = model.n_active_params()
            if shape.kind == "train":
                mf = 6.0 * n_active * b * s
            elif shape.kind == "prefill":
                mf = 2.0 * n_active * b * s
            else:
                mf = 2.0 * n_active * b
            out[f"{arch}|{name}|{int(multi)}"] = {
                "rules": [[[k, list(v)] for k, v in dryrun.sharding_rules_for(
                    name, b, ms, ep2d=e).rules] for e in (False, True)],
                "inputs": {k: [list(v.shape), str(v.dtype)]
                           for k, v in batch.items()},
                "batch_spec": tree(dryrun.batch_spec(batch, rules, ms)),
                "specs": [tree(t) for t in shardings],
                "flops": [mf, model.n_params(), n_active],
            }
json.dump(out, open(sys.argv[1], "w"))
"""

REFERENCE_MESH = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.hloparse import collective_bytes, dot_flops
from repro.launch.mesh import make_host_mesh, mesh_shape_dict
from repro.models import build_model
from repro.models.param import ParamDef, ShardingRules, map_tree, spec_for
from repro.models.sharding_ctx import axis_rules
from repro.optim.optimizer import OptimizerConfig
from repro.train.step import make_train_step

cells, batch_n, seq = json.loads(sys.argv[2])
mesh = make_host_mesh(data=2, model=4)
ms = mesh_shape_dict(mesh)
sds = jax.ShapeDtypeStruct
# the reference dry-run's rules (its module sets 512 host devices at
# import, so its functions are not imported here)
DECODE = dict(kv_seq=("model",), embed=(), embed_pod=())
out = {}
for arch, name, kind in cells:
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    rules = ShardingRules()
    if kind == "decode":
        rules = rules.with_overrides(**DECODE)
    b, s = batch_n, seq
    i32 = jnp.int32
    if kind == "train":
        batch = {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
    elif kind == "prefill":
        batch = {"tokens": sds((b, s), i32)}
    else:
        batch = {"tokens": sds((b, 1), i32), "pos": sds((b,), i32)}
    if cfg.enc_dec and kind != "decode":    # the stub frontend's frames
        batch["frames"] = sds((b, cfg.n_frames, cfg.d_model), jnp.bfloat16)
    bspecs = {k: spec_for(ParamDef(v.shape, ("batch",) + (None,) * (
        len(v.shape) - 1), v.dtype), rules, ms) for k, v in batch.items()}
    shard = lambda t: map_tree(lambda p: NamedSharding(mesh, p), t)
    pspecs = model.param_specs(rules, ms)
    if kind == "train":
        fn = make_train_step(model, OptimizerConfig(), mesh=mesh,
                             remat="save_attn")
        ps = model.param_shapes()
        args = ({"params": ps, "opt": {"m": ps, "v": ps,
                                       "step": sds((), i32)}}, batch)
        sh = ({"params": shard(pspecs),
               "opt": {"m": shard(pspecs), "v": shard(pspecs),
                       "step": NamedSharding(mesh, P())}}, shard(bspecs))
    elif kind == "prefill":
        fn = lambda p, bb: model.prefill(p, bb, skv=s, mesh=mesh)
        args = (model.param_shapes(dtype=jnp.bfloat16), batch)
        sh = (shard(pspecs), shard(bspecs))
    else:
        fn = lambda p, c, bb: model.decode_step(p, c, bb, mesh=mesh)
        args = (model.param_shapes(dtype=jnp.bfloat16),
                model.cache_shapes(b, s), batch)
        sh = (shard(pspecs), shard(model.cache_specs(b, s, rules, ms)),
              shard(bspecs))
    with mesh, axis_rules(rules, ms):
        compiled = jax.jit(fn, in_shardings=sh, keep_unused=True).lower(
            *args).compile()
    hlo = compiled.as_text()
    total, kinds = collective_bytes(hlo)
    out[f"{arch}|{name}"] = {
        "argument_size_bytes":
            compiled.memory_analysis().argument_size_in_bytes,
        "dot_flops": dot_flops(hlo), "collective_bytes": total,
        "collective_kinds": kinds}
json.dump(out, open(sys.argv[1], "w"))
"""


def _env(devices=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    if devices:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={devices}"
    return env


def _run(args, what, env):
    proc = subprocess.run(args, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, (what, proc.stdout[-2000:],
                                  proc.stderr[-3000:])
    return proc


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "cells.json")
    _run([sys.executable, "-c", textwrap.dedent(REFERENCE_CELLS), path],
         "reference cells", _env())
    with open(path) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's (2,4) compiles and the port's 8 real gloo ranks,
    side by side; returns (reference, real) keyed ``arch|shape``."""
    work = str(tmp_path_factory.mktemp("dryrun24"))
    ref_path = os.path.join(work, "ref.json")
    cells = json.dumps([ranks.DRYRUN_CELLS, ranks.DRYRUN_BATCH,
                        ranks.DRYRUN_SEQ])
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(AUTO_AXES + REFERENCE_MESH),
         ref_path, cells], env=_env(8), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
    _run([sys.executable, HELPER, "dryrun8", work], "gloo ranks", _env())
    _, err = ref.communicate(timeout=TIMEOUT)
    assert ref.returncode == 0, err[-3000:]
    with open(ref_path) as fh:
        reference = json.load(fh)
    real = json.loads(str(np.load(os.path.join(work, "dryrun8.npz"))[
        "json"]))
    return reference, real


def _spec_data(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return _spec_data(tree)


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("multi", [False, True],
                         ids=["single_pod", "multi_pod"])
@pytest.mark.parametrize("arch,name", CELLS)
def test_cell_data_matches_reference(ref_cells, arch, name, multi):
    want = ref_cells[f"{arch}|{name}|{int(multi)}"]
    cfg, shape = get_config(arch), SHAPES[name]
    mshape, axes = PRODUCTION_MESHES[multi]
    ms = dict(zip(axes, mshape))
    b = shape.global_batch
    assert [[[k, list(v)] for k, v in dryrun.sharding_rules_for(
        name, b, ms, ep2d=e).rules] for e in (False, True)] == want["rules"]
    batch = dryrun.input_specs(arch, name)
    assert all(v.device.type == "meta" for v in batch.values())
    assert {k: [list(v.shape), _dtype(v.dtype)]
            for k, v in batch.items()} == want["inputs"]
    ep2d = shape.kind == "decode" and cfg.moe is not None and \
        cfg.moe.n_experts >= 64
    rules = dryrun.sharding_rules_for(name, b, ms, ep2d=ep2d)
    assert _spec_tree(dryrun.batch_spec(batch, rules, ms)) == \
        want["batch_spec"]
    with dryrun.fake_process_group(math.prod(mshape)):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        with dryrun.fake_mode():
            _, args, specs = dryrun.build_cell(arch, name, mesh, "cpu")

            def check(x, spec):      # each argument is its spec's shard
                assert isinstance(x, DTensor)
                assert tuple(x.placements) == tuple(placements(spec, mesh))
                local = list(x.shape)
                for i, p in enumerate(x.placements):
                    if hasattr(p, "dim"):
                        local[p.dim] //= mesh.size(i)
                assert list(x._local_tensor.shape) == local

            for a, s in zip(args, specs):
                spec_map(check, a, s)
    assert [_spec_tree(t) for t in specs] == want["specs"]
    assert list(dryrun.model_flops(cfg, shape)) == want["flops"]


def _fake24(arch, name, kind):
    with dryrun.fake_process_group(8):
        mesh = make_host_mesh(2, 4, device="cpu")
        with dryrun.fake_mode():
            return dryrun.trace_cell(*ranks.dryrun_cell(arch, name, kind),
                                     mesh, CPU)


@pytest.mark.parametrize("arch,name,kind", SPLIT_CELLS)
def test_mesh_flops_match_reference_and_argument_bytes(
        mesh_runs, arch, name, kind):
    """A rank's FLOPs on (2,4) within 10% of the reference's per-device
    ``dot_flops`` of the same step, and its argument bytes equal. Both
    split the rows over "data" and the heads, the FFN columns and the
    vocabulary over "model", each rank projecting only the kv heads its
    query heads read (2 kv heads do not split 4 ways); the Mamba2 layers
    over ``ffn`` and ``ssm_heads`` with B and C whole. Measured: prefill
    and decode equal exactly; in train the port is above by exactly one
    attention-sized product a layer (2 * b * h * s * s * d, b and h the
    rank's rows and heads: qwen2.5-3b +1.75%, gemma3-1b +2.13%), which
    the reference's one-device program forms as the port does
    (``test_torch_dryrun_compiled.py``: equal there) and its partitioned
    program does not; mamba2-780m +1.89%, zamba2-2.7b +2.43%,
    whisper-small +2.03% (before their layers split: 2.865x, 3.392x and
    3.334x)."""
    reference, _ = mesh_runs
    want = reference[f"{arch}|{name}"]
    cfg, shape = ranks.dryrun_cell(arch, name, kind)
    with dryrun.fake_mode():
        one = dryrun.trace_cell(cfg, shape, None, CPU)
    got = _fake24(arch, name, kind)
    ratio = got["flops_per_chip"] / want["dot_flops"]
    print(f"{arch} {name}: port (2,4) flops {got['flops_per_chip']} "
          f"(one device {one['flops_per_chip']}); reference (2,4) dot "
          f"flops {want['dot_flops']}: {ratio:.4f}; collectives port "
          f"{got['collective_kinds']} ({got['collective_counts']}) vs "
          f"reference {want['collective_kinds']}")
    assert 0.9 <= ratio <= 1.1
    assert got["memory_analysis"]["argument_size_bytes"] == \
        want["argument_size_bytes"]


@pytest.mark.parametrize("arch,name,kind", ranks.DRYRUN_CELLS)
def test_fake_group_counts_equal_real_gloo_ranks(mesh_runs, arch, name,
                                                 kind):
    _, real = mesh_runs
    got = _fake24(arch, name, kind)
    want = real[f"{arch}|{name}"]
    for key in ("collective_kinds", "collective_counts",
                "collective_bytes_per_chip", "flops_per_chip",
                "bytes_per_chip", "kernel_ops", "memory_analysis"):
        assert got[key] == want[key], key
    assert got["collective_counts"]        # a (2,4) step moves data


def _gathered_bytes(shape, dtype, spec, mesh, keep=("model",)) -> int:
    """``tp_leaf``'s all-gather bytes (result plus operand) for one leaf
    of ``shape`` under ``spec``: over each mesh dimension that splits it
    but those in ``keep`` ("model", whose split a layer keeps; none for a
    leaf gathered whole), the last first."""
    pl = placements(spec, mesh)
    n = math.prod(shape)
    for i, p in enumerate(pl):
        if hasattr(p, "dim"):
            n //= mesh.size(i)
    size = torch.empty((), dtype=dtype).element_size()
    total = 0
    for i in reversed(range(mesh.ndim)):
        if hasattr(pl[i], "dim") and mesh.size(i) > 1 and \
                mesh.mesh_dim_names[i] not in keep:
            total += (n + n * mesh.size(i)) * size
            n *= mesh.size(i)
    return total


def _traced_forward(arch):
    """``Model.forward(mesh=)`` of ``arch`` reduced on (2,4) over a fake
    group, the whole batch of the dry-run's (2,4) cells on every rank:
    (the trace's analysis, the all-gather bytes the spec tree predicts,
    the config, the batch rows and sequence length, the logits' local
    shape)."""
    cfg, shape = ranks.dryrun_cell(arch, "train_4k", "train")
    model = build_model(cfg)
    b, s = shape.global_batch, shape.seq_len
    with dryrun.fake_process_group(8):
        mesh = make_host_mesh(2, 4, device="cpu")
        ms = {"data": 2, "model": 4}
        specs = model.param_specs(ShardingRules(), ms)
        defs = model.param_defs()
        want = 0
        for top in defs:
            for d, spec in zip(tree_leaves(defs[top]),
                               tree_leaves(specs[top])):
                if top == "layers":      # one layer's slice, each layer
                    want += cfg.n_layers * _gathered_bytes(
                        d.shape[1:], d.dtype, tuple(spec)[1:], mesh)
                else:
                    want += _gathered_bytes(d.shape, d.dtype, spec, mesh)
        with dryrun.fake_mode():
            params = spec_map(lambda d, sp: dryrun._placed(d, sp, mesh, CPU),
                              defs, specs)
            tokens = torch.zeros((b, s), dtype=torch.int32)
            (logits, _), an = dryrun.trace(lambda p, t: model.forward(
                p, {"tokens": t}, mesh=mesh), (params, tokens))
            local = tuple(logits.to_local().shape)
    return an, want, cfg, b, s, local


def test_forward_gathers_what_the_spec_tree_predicts():
    """qwen2.5-3b reduced, ``Model.forward(mesh=)`` on (2,4) with the
    whole batch on every rank: each stacked leaf is all-gathered over
    "data" alone once a layer and each other leaf once (a "model" split
    is kept); the vocabulary-parallel lookup's bf16 rows of the rank and
    each sublayer's f32 row-parallel sum are all-reduced over "model";
    the logits stay the rank's (nothing else moves)."""
    an, want, cfg, b, s, local = _traced_forward("qwen2.5-3b")
    assert local == (b // 2, s, cfg.vocab // 4)
    rows = b // 2 * s * cfg.d_model      # a rank's residual stream
    # an all-reduce moves its operand and its result
    reduced = 2 * (rows * 2 + cfg.n_layers * 2 * rows * 4)
    assert an["collective_kinds"] == {"all-gather": want,
                                      "all-reduce": reduced}
    assert an["collective_counts"]["all-reduce"] == 1 + 2 * cfg.n_layers


def test_ssm_forward_moves_no_weight_over_model():
    """mamba2-780m reduced, ``Model.forward(mesh=)`` on (2,4) with the
    whole batch on every rank: each leaf is all-gathered over "data"
    alone (the "model" splits of ``ffn`` and ``ssm_heads`` are kept, and
    ``wB``, ``wC``, ``conv_B`` and ``conv_C``, whole over "model", move
    nothing over it); over "model" move only the vocabulary-parallel
    lookup's bf16 rows and, each layer, its gated norm's f32 sum of
    squares (one number a row) and its row-parallel ``wo`` sum (f32)."""
    an, want, cfg, b, s, local = _traced_forward("mamba2-780m")
    assert local == (b // 2, s, cfg.vocab // 4)
    rows = b // 2 * s
    reduced = 2 * (rows * cfg.d_model * 2
                   + cfg.n_layers * (rows * 4 + rows * cfg.d_model * 4))
    assert an["collective_kinds"] == {"all-gather": want,
                                      "all-reduce": reduced}
    assert an["collective_counts"]["all-reduce"] == 1 + 2 * cfg.n_layers


EXPERTS = ("w1", "w3", "w2")


def _traced_ep2d_decode(ep2d: bool, dense: bool = False):
    """One decode step of ``ranks.EP2D_STATIONARY`` (qwen3-moe reduced,
    the experts padded to 8 = data x model) traced as rank 0 of a fake
    (2,4) group at batch ``ranks.EP2D_BATCH`` against a ``DRYRUN_SEQ``
    cache, under the dry-run's decode rules with (``ep2d``) or without
    the 2-D EP override, the parameters and caches placed under them;
    with ``dense`` the same stack with an MLP in place of the MoE block.
    Returns (the trace's analysis, the config, the layer leaves' specs,
    the all-gather bytes the spec tree predicts for the leaves but the
    experts, those it predicts for gathering the experts whole)."""
    name, arch, kw = ranks.EP2D_STATIONARY
    cfg = ranks.moe_config(arch, kw)
    if dense:
        cfg = dataclasses.replace(cfg, family="dense", moe=None)
    model = build_model(cfg)
    b, skv = ranks.EP2D_BATCH, ranks.DRYRUN_SEQ
    ms = {"data": 2, "model": 4}
    rules = dryrun.sharding_rules_for("decode_32k", b, ms, ep2d=ep2d)
    with dryrun.fake_process_group(8):
        mesh = make_host_mesh(2, 4, device="cpu")
        defs, specs = model.param_defs(), model.param_specs(rules, ms)
        leaves, experts = 0, 0
        flat_specs = ranks.flat(specs)
        for key, d in ranks.flat(defs).items():
            spec = flat_specs[key]
            if key.startswith("layers/"):   # one layer's slice, each layer
                shape, spec = d.shape[1:], tuple(spec)[1:]
                n = cfg.n_layers
            else:
                shape, n = d.shape, 1
            if key.rsplit("/", 1)[-1] in EXPERTS:
                experts += n * _gathered_bytes(shape, torch.bfloat16, spec,
                                               mesh, keep=())
            else:
                leaves += n * _gathered_bytes(shape, torch.bfloat16, spec,
                                              mesh)
        with axis_rules(rules, ms), dryrun.fake_mode():
            params = spec_map(lambda d, sp: dryrun._placed(
                dataclasses.replace(d, dtype=torch.bfloat16), sp, mesh, CPU),
                defs, specs)
            caches = spec_map(lambda d, sp: dryrun._placed(d, sp, mesh, CPU),
                              model.cache_defs(b, skv),
                              model.cache_specs(b, skv, rules, ms))
            batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32),
                     "pos": torch.full((b,), skv - 1, dtype=torch.int32)}
            _, an = dryrun.trace(lambda p, c, t: model.decode_step(
                p, c, t, mesh=mesh), (params, caches, batch))
    return an, cfg, specs["layers"], leaves, experts


def test_ep2d_decode_moves_no_expert_weight():
    """The reduced 2-D EP decode step on (2,4) under the dry-run's 2-D
    EP serving rules: the experts lie over ("data", "model"), one a rank,
    and the step moves none of them. Exactly: its all-gathers are the
    MoE tokens' gather over "data" (each layer, the rank's bf16 rows and
    the whole batch's) plus what the same stack with a dense MLP gathers
    in its attention (the decoded token's query heads and k and v), plus
    the non-expert leaves' gathers that the spec tree predicts (none:
    the serving rules split no leaf over "data"); its all-reduces are the
    dense stack's with each layer's MLP row-parallel sum (f32) replaced by
    the MoE's bf16 psum over "data" and over "model". The same step under
    the decode rules without the override (the experts over "model"
    alone, gathered whole at use) gathers exactly the experts' whole
    bytes more, and moves the same all-reduces."""
    still, cfg, specs, leaves, _ = _traced_ep2d_decode(ep2d=True)
    moved, _, _, leaves0, experts = _traced_ep2d_decode(ep2d=False)
    dense, dcfg, _, dleaves, _ = _traced_ep2d_decode(ep2d=True, dense=True)
    assert all(tuple(specs["moe"][n])[1] == ("data", "model")
               for n in EXPERTS)
    b, d, n_layers = ranks.EP2D_BATCH, cfg.d_model, cfg.n_layers
    bl = b // 2
    tokens = n_layers * (bl * d + b * d) * 2
    mlp_sum = 2 * bl * d * 4               # an all-reduce: operand + result
    moe_psum = 2 * (2 * b * d * 2)         # over "data" and over "model"
    kinds = dense["collective_kinds"]
    assert experts > 0 and leaves == leaves0 == dleaves == 0
    assert still["collective_kinds"] == {
        "all-gather": kinds["all-gather"] - dleaves + tokens + leaves,
        "all-reduce": kinds["all-reduce"]
        + n_layers * (moe_psum - mlp_sum)}
    assert moved["collective_kinds"] == {
        "all-gather": still["collective_kinds"]["all-gather"] + experts,
        "all-reduce": still["collective_kinds"]["all-reduce"]}
    print(f"2-D EP decode on (2,4): all-gather "
          f"{still['collective_kinds']['all-gather']} B stationary, "
          f"{moved['collective_kinds']['all-gather']} B gathering the "
          f"experts whole ({experts} B of them); all-reduce "
          f"{still['collective_kinds']['all-reduce']} B")


def test_cli_writes_what_roofline_renders(tmp_path):
    """Full size on the fake 256-rank mesh, through the CLI; the JSON
    holds every key the reference's does but the compiled program's,
    and ``benchmarks/roofline.py`` renders it unchanged."""
    out = str(tmp_path / "dryrun_torch")
    proc = _run([sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", "gemma3-1b", "--shape", "train_4k", "--device",
                 "cpu", "--out", out], "CLI", _env())
    assert proc.stdout.startswith("OK  gemma3-1b"), proc.stdout
    with open(os.path.join(out, "gemma3-1b__train_4k__single_pod_16x16"
                                ".json")) as fh:
        r = json.load(fh)
    for key in ("arch", "shape", "mesh", "n_chips", "kind", "trace_s",
                "hlo_flops", "hlo_bytes", "flops_per_chip",
                "bytes_per_chip", "collective_bytes_per_chip",
                "collective_bytes", "collective_kinds", "memory_analysis",
                "model_flops", "useful_flops_ratio", "roofline_fraction",
                "n_params", "n_active_params", "roofline", "dominant"):
        assert key in r, key
    assert set(r["memory_analysis"]) == {
        "argument_size_bytes", "output_size_bytes", "temp_size_bytes",
        "peak_bytes"}
    assert r["n_chips"] == 256 and r["mesh"] == "single_pod_16x16"
    assert r["hlo_flops"] == 256 * r["flops_per_chip"] > 0
    assert set(r["collective_kinds"]) >= {"all-gather", "reduce-scatter",
                                          "all-reduce"}
    assert r["dominant"] == max(r["roofline"], key=r["roofline"].get)
    table = _run([sys.executable, "-c", "from benchmarks.roofline import "
                  "markdown_table; print(markdown_table())"], "roofline",
                 dict(_env(), DRYRUN_DIR=out)).stdout
    assert "| gemma3-1b | train_4k |" in table, table


def test_run_cell_refuses_a_real_group(tmp_path):
    """The fake group must be the process's own: a real group up (a
    gloo one here) is refused before anything is built."""
    from torch_dist_ranks import one_rank_mesh
    with one_rank_mesh("cpu"):
        with pytest.raises(RuntimeError, match="real process group"):
            dryrun.run_cell("gemma3-1b", "train_4k", False, str(tmp_path),
                            device="cpu")
    assert not os.listdir(tmp_path)
