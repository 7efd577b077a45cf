"""Multi-pod dry-run: trace every (arch x shape x mesh) cell as one rank
of the production meshes and record its memory, FLOP, traffic and
collective analyses.

The reference lowers and compiles each cell on 512 placeholder host
devices. The port runs one rank's program instead: under
``FakeTensorMode`` (tensors with shapes, dtypes and devices but no
data), on a ``"fake"`` process group of 256 or 512 ranks (collectives
that move nothing), over the port's own ``DeviceMesh``. The step is the
port's own code, as a user calls it; nothing is materialised at full
size. What is recorded is the rank's traced eager op stream, read at
the dispatcher (``_Trace``), not a compiled program:

- FLOPs: ``FlopCounterMode``'s total for the rank (forward, backward and
  the recomputation under remat): ``flops_per_chip``. ``hlo_flops`` is
  that times the mesh's size, under the reference's key name;
- traffic (``bytes_per_chip``): for every aten op that launches a
  kernel, the bytes of its tensor inputs plus its outputs. View and
  alias ops, allocations and collectives count 0. This is the port's
  own model of its eager code, an upper bound on its DRAM traffic (an
  input read twice by one kernel, or a broadcast, counts at its size),
  not ``hloparse``'s fused-HLO model; ``kernel_ops`` counts those ops;
- collectives: each c10d op the rank issues, under ``hloparse``'s kind
  names (``_allgather_base_`` as ``"all-gather"``,
  ``_reduce_scatter_base_`` as ``"reduce-scatter"``, ``allreduce_`` as
  ``"all-reduce"``, all-to-all and point-to-point ops as
  ``"all-to-all"`` and ``"collective-permute"``), its bytes the
  reference's model: result plus operand sizes;
- memory: ``argument_size_bytes`` (the rank's local bytes of every
  argument), ``output_size_bytes`` (of every output, arguments updated
  in place included), ``peak_bytes`` (the arguments plus the most the
  step's own allocations hold at once: each storage an op makes counts
  from its making until its last tensor dies) and ``temp_size_bytes``
  (the peak above the arguments and the step's new outputs).

The roofline takes the card's data-sheet rates in place of the
reference's TPU v5e constants.

Usage (the card unless ``--device`` names another; the CPU tests pass
``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``DRYRUN_DIR=artifacts/dryrun_torch python benchmarks/roofline.py``
renders the table of the JSON files it writes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import defaultdict
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from ..configs import REGISTRY, SHAPES, get_config, shape_applicable
from ..configs.base import ArchConfig, ShapeConfig
from ..core.bitvector import resolve_device
from ..models import build_model
from ..models.param import (ParamDef, PartitionSpec, ShardingRules,
                            map_tree, placements, spec_for)
from ..models.sharding_ctx import axis_rules, mesh_shape_dict, spec_map
from ..optim.optimizer import OptimizerConfig
from ..train.step import make_train_step
from .mesh import PRODUCTION_MESHES, make_production_mesh

# Hardware model: NVIDIA H100 SXM5 80GB (700 W) data sheet figures.
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
# A collective over a 16-way axis spans two HGX nodes of 8 GPUs; each
# GPU meets the other node through one 400 Gb/s NDR InfiniBand port.
NET_BW = 50e9              # bytes/s a GPU

P = PartitionSpec


def sharding_rules_for(shape_name: str, batch: int,
                       mesh_axes, ep2d: bool = False) -> ShardingRules:
    """Baseline rules per shape kind (the reference's).

    decode_32k: the KV cache dominates memory and GQA kv_heads rarely
    divide the 16-way TP axis, so the cache SEQUENCE dim shards over
    "model"; weights are not FSDP-sharded (a per-token regather would
    bind the collective term); 2-D EP cells shard experts over
    (data x model).

    long_500k (batch=1): batch axes idle; the cache seq shards over BOTH
    data and model (512-way on the multi-pod mesh); weights replicate
    over the idle data axis."""
    rules = ShardingRules()
    if shape_name == "long_500k" or batch == 1:
        return rules.with_overrides(batch=(), kv_seq=("data", "model"),
                                    embed=(), embed_pod=())
    if shape_name.startswith("decode"):
        over = dict(kv_seq=("model",), embed=(), embed_pod=())
        if ep2d:
            over["expert"] = ("data", "model")
        return rules.with_overrides(**over)
    return rules


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _inputs(cfg: ArchConfig, shape: ShapeConfig, device) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": _empty((b, s), i32, device),
                 "labels": _empty((b, s), i32, device)}
    elif shape.kind == "prefill":
        batch = {"tokens": _empty((b, s), i32, device)}
    else:  # decode: one new token against a seq_len cache
        batch = {"tokens": _empty((b, 1), i32, device),
                 "pos": _empty((b,), i32, device)}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["vision_embeds"] = _empty((b, cfg.vision_tokens, cfg.d_model),
                                        torch.bfloat16, device)
        batch["vision_positions"] = _empty((b, cfg.vision_tokens), i32,
                                           device)
        batch["mrope_positions"] = _empty((3, b, s), i32, device)
    if cfg.enc_dec and shape.kind != "decode":
        batch["frames"] = _empty((b, cfg.n_frames, cfg.d_model),
                                 torch.bfloat16, device)
    return batch


def input_specs(arch: str, shape_name: str, device=None) -> Dict[str, Any]:
    """Shape-and-dtype stand-ins for every model input of this cell:
    meta tensors, or on ``device`` (fake ones under a
    ``FakeTensorMode``)."""
    return _inputs(get_config(arch), SHAPES[shape_name], device or "meta")


def batch_spec(batch: Dict[str, Any], rules: ShardingRules,
               mesh_shape: Dict[str, int]) -> Dict[str, Any]:
    """PartitionSpecs for the input batch (batch dim over DP axes)."""
    table = {}
    for k, v in batch.items():
        if k == "mrope_positions":
            axes = (None, "batch") + (None,) * (len(v.shape) - 2)
        else:
            axes = ("batch",) + (None,) * (len(v.shape) - 1)
        table[k] = spec_for(ParamDef(tuple(v.shape), axes, v.dtype), rules,
                            mesh_shape)
    return table


def _ep2d(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    return (shape.kind == "decode" and cfg.moe is not None
            and cfg.moe.n_experts >= 64)


def _placed(d: ParamDef, spec, mesh, device) -> torch.Tensor:
    """A zero tensor of ``d``'s shape and dtype: this rank's shard of it
    under ``spec`` as a DTensor on ``mesh``, or whole without a mesh.
    Only the shard is made."""
    if mesh is None:
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    pl = placements(spec, mesh)
    local = list(d.shape)
    for i, p in enumerate(pl):
        if hasattr(p, "dim"):
            local[p.dim] //= mesh.size(i)
    stride, acc = [], 1
    for n in reversed(d.shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(
        torch.zeros(local, dtype=d.dtype, device=device), mesh, pl,
        run_check=False, shape=torch.Size(d.shape), stride=tuple(stride))


def _cell(cfg: ArchConfig, shape: ShapeConfig, mesh, device):
    """(fn, args, specs) of a cell; ``cfg`` unpadded."""
    ms = mesh_shape_dict(mesh) if mesh is not None else {}
    ep2d = _ep2d(cfg, shape)
    if ep2d:
        # serving config: pad experts to data*model for the 2D
        # expert-parallel path (weights stationary)
        pad2d = ms.get("data", 1) * ms.get("model", 1)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, pad_to=pad2d))
    model = build_model(cfg)
    rules = sharding_rules_for(shape.name, shape.global_batch, ms, ep2d=ep2d)
    pdefs = model.param_defs()
    pspecs = model.param_specs(rules, ms)
    batch_defs = {k: ParamDef(tuple(v.shape), (None,) * v.ndim, v.dtype)
                  for k, v in _inputs(cfg, shape, "meta").items()}
    bspecs = batch_spec(batch_defs, rules, ms)

    def place(defs, specs):
        return spec_map(lambda d, s: _placed(d, s, mesh, device), defs,
                        specs)

    batch = place(batch_defs, bspecs)
    if shape.kind == "train":
        step_fn = make_train_step(model, OptimizerConfig(), mesh=mesh,
                                  remat="save_attn")
        step = ParamDef((), (), torch.int32)
        state = {"params": place(pdefs, pspecs),
                 "opt": {"m": place(pdefs, pspecs),
                         "v": place(pdefs, pspecs),
                         "step": place(step, P())}}
        specs = {"params": pspecs,
                 "opt": {"m": pspecs, "v": pspecs, "step": P()}}
        return step_fn, (state, batch), (specs, bspecs)

    serve_defs = map_tree(lambda d: dataclasses.replace(
        d, dtype=torch.bfloat16), pdefs)
    params = place(serve_defs, pspecs)
    if shape.kind == "prefill":
        def fn(params, b):
            return model.prefill(params, b, skv=shape.seq_len, mesh=mesh)
        return fn, (params, batch), (pspecs, bspecs)

    cdefs = model.cache_defs(shape.global_batch, shape.seq_len)
    cspecs = model.cache_specs(shape.global_batch, shape.seq_len, rules, ms)

    def fn(params, caches, b):
        return model.decode_step(params, caches, b, mesh=mesh)

    return (fn, (params, place(cdefs, cspecs), batch),
            (pspecs, cspecs, bspecs))


def build_cell(arch: str, shape_name: str, mesh, device=None):
    """(fn, args, specs): the cell's step function, its arguments (this
    rank's shards as DTensors under ``spec_for``'s placements on
    ``mesh``, zeros; fake ones when built under a ``FakeTensorMode``) and
    the spec trees they lie under, as the reference's in-shardings. The
    device is the card unless ``device`` names another."""
    return _cell(get_config(arch), SHAPES[shape_name], mesh,
                 resolve_device(device))


# ---------------------------------------------------------------------------
# The trace: kernels, bytes, collectives and live memory of one rank
# ---------------------------------------------------------------------------


def _c10d_kinds() -> Dict[Any, str]:
    c10d, fn = torch.ops.c10d, torch.ops._c10d_functional
    kinds = {
        "all-gather": (c10d._allgather_base_, c10d.allgather_,
                       fn.all_gather_into_tensor),
        "reduce-scatter": (c10d._reduce_scatter_base_, c10d.reduce_scatter_,
                           fn.reduce_scatter_tensor),
        "all-reduce": (c10d.allreduce_, fn.all_reduce, fn.all_reduce_),
        "all-to-all": (c10d.alltoall_base_, c10d.alltoall_,
                       fn.all_to_all_single),
        "collective-permute": (c10d.send, c10d.recv_),
        "broadcast": (c10d.broadcast_, fn.broadcast),
    }
    return {op.default: kind for kind, ops in kinds.items() for op in ops}


# aten ops that only allocate, read a value or alias: no kernel
_NO_KERNEL = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "_local_scalar_dense", "lift_fresh",
              "detach", "alias", "resize_", "set_"}


def _launches(func) -> bool:
    """Whether an op launches a kernel: an aten op that is no view and
    no mere allocation (``prim`` ops read metadata, such as a fake
    tensor's device)."""
    ns, _, name = func._schema.name.partition("::")
    return ns == "aten" and not func.is_view and name not in _NO_KERNEL


def _tensors(tree):
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's own local tensor (not a view of it), or ``t``."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _storages(tree) -> Dict[int, int]:
    """{key: bytes} of the distinct storages under ``tree``'s tensors (a
    DTensor's local shard)."""
    return {_storage_key(t): t.untyped_storage().nbytes()
            for t in _tensors(_locals(tree))}


def _locals(tree):
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_locals(v) for v in tree]
    return _local(tree) if isinstance(tree, torch.Tensor) else tree


class _Trace(TorchDispatchMode):
    """Reads the rank's op stream at the dispatcher: kernel-launching ops
    and their bytes, each collective's kind, count and bytes, and the
    live bytes of the storages the ops make (the storages under
    ``held`` were live before and are not counted)."""

    def __init__(self, held=()):
        super().__init__()
        self.kinds = _c10d_kinds()
        self.kernel_ops = 0
        self.bytes = 0
        self.coll_bytes: Dict[str, int] = defaultdict(int)
        self.coll_count: Dict[str, int] = defaultdict(int)
        self.held = set(held)
        self.live = self.peak = 0
        self._alive: Dict[int, list] = {}
        # the storage a collective just wrote: a copy into it before any
        # op but a view is the backend's own completion of the collective
        self._landing = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # A DTensor op runs its local op (and its metadata propagation on
        # global shapes) below this mode, unseen: it is read here, on its
        # local tensors. The port's steps run none but ``detach``.
        ins, outs = _tensors(_locals([args, kwargs])), _tensors(_locals(out))
        kind = self.kinds.get(func)
        landing = self._landing
        if not func.is_view:
            self._landing = None
        if kind is not None:
            self._collective(kind, func, ins, outs)
            self._landing = _storage_key(ins[0]) if ins else None
        elif func is torch.ops.aten.copy_.default and \
                landing == _storage_key(ins[0]):
            pass    # gloo's Work.wait copies a reduce-scatter's result in
        elif _launches(func):
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if moved:
                self.kernel_ops += 1
                self.bytes += moved
        for t in outs:
            self._track(t)
        return out

    def _collective(self, kind, func, ins, outs):
        # result plus operand: a c10d op writes into its first tensor
        # argument (in place for an all-reduce or a broadcast, whose
        # result is its operand; a send or a receive moves its tensor
        # once); a functional one returns its result
        moved = sum(map(_nbytes, ins))
        if func._schema.name.startswith("_c10d_functional"):
            moved += sum(map(_nbytes, outs))
        elif kind in ("all-reduce", "broadcast"):
            moved *= 2
        self.coll_bytes[kind] += moved
        self.coll_count[kind] += 1

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self.held:
            return
        entry = self._alive.get(key)
        if entry is None:
            entry = self._alive[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._alive[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._alive[key]


def trace(fn, args) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` under the counting modes (inside a
    ``FakeTensorMode`` for the dry-run, or on real tensors, as the tests'
    gloo ranks do) and return (its output, the rank's analyses)."""
    from torch.utils.flop_counter import FlopCounterMode
    held = _storages(list(args))
    with FlopCounterMode(display=False) as flops, _Trace(held) as tr:
        out = fn(*args)
    made = _storages(out)
    arg_bytes = sum(held.values())
    new_out = sum(n for k, n in made.items() if k not in held)
    return out, {
        "flops_per_chip": float(flops.get_total_flops()),
        "bytes_per_chip": float(tr.bytes),
        "kernel_ops": tr.kernel_ops,
        "collective_bytes_per_chip": float(sum(tr.coll_bytes.values())),
        "collective_kinds": dict(tr.coll_bytes),
        "collective_counts": dict(tr.coll_count),
        "memory_analysis": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": sum(made.values()),
            "temp_size_bytes": max(tr.peak - new_out, 0),
            "peak_bytes": arg_bytes + tr.peak,
        },
    }


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[float, int,
                                                              int]:
    """(MODEL_FLOPS, n_params, n_active_params) of the unpadded model:
    6*N_active*D to train, 2*N_active*D to prefill, 2*N_active a decoded
    token."""
    model = build_model(cfg)
    n_params, n_active = model.n_params(), model.n_active_params()
    if shape.kind == "train":
        mf = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        mf = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        mf = 2.0 * n_active * shape.global_batch
    return mf, n_params, n_active


def mesh_name(mesh) -> str:
    if mesh is None:
        return "one_device"
    dims = tuple(int(n) for n in mesh.mesh.shape)
    for multi, (shape, _) in PRODUCTION_MESHES.items():
        if dims == shape:
            return "multi_pod_2x16x16" if multi else "single_pod_16x16"
    return "mesh_" + "x".join(str(n) for n in dims)


def fake_mode():
    """The ``FakeTensorMode`` the dry-run traces under. The mesh's rank
    table is a real tensor that ``DeviceMesh`` reads inside it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               device) -> Dict[str, Any]:
    """``trace`` of one cell's step (``cfg`` unpadded, ``shape`` any
    ``ShapeConfig``) as this rank of ``mesh`` (None: one device) runs
    it, under the reference's ambient rules (the batch rules of the
    shape, without the 2-D EP override). Fake under ``fake_mode``, real
    outside it."""
    ms = mesh_shape_dict(mesh) if mesh is not None else {}
    rules = sharding_rules_for(shape.name, shape.global_batch, ms)
    ctx = axis_rules(rules, ms) if mesh is not None \
        else contextlib.nullcontext()
    with ctx:
        fn, args, _ = _cell(cfg, shape, mesh, device)
        return trace(fn, args)[1]


def analyse_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                 device=None) -> Dict[str, Any]:
    """The analyses of one cell (``cfg`` as configured, ``shape`` any
    ``ShapeConfig``) as this rank of ``mesh`` (a ``DeviceMesh`` over the
    process group, or None for one device) runs it, traced under
    ``fake_mode`` on ``device`` (the card unless named): the module
    docstring's quantities and the roofline."""
    dev = resolve_device(device)
    ms = mesh_shape_dict(mesh) if mesh is not None else {}
    n_chips = math.prod(ms.values()) if ms else 1
    t0 = time.perf_counter()
    with fake_mode():
        an = trace_cell(cfg, shape, mesh, dev)
    trace_s = time.perf_counter() - t0
    mf, n_params, n_active = model_flops(cfg, shape)
    flops_dev, bytes_dev = an["flops_per_chip"], an["bytes_per_chip"]
    coll = an["collective_bytes_per_chip"]
    hlo_flops = flops_dev * n_chips
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": coll / NET_BW}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    ideal_s = mf / (n_chips * PEAK_FLOPS)
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name(mesh),
        "n_chips": n_chips, "kind": shape.kind, "device": dev.type,
        "trace_s": trace_s,
        "hlo_flops": hlo_flops, "hlo_bytes": bytes_dev * n_chips,
        "flops_per_chip": flops_dev, "bytes_per_chip": bytes_dev,
        "kernel_ops": an["kernel_ops"],
        "collective_bytes_per_chip": coll, "collective_bytes": coll,
        "collective_kinds": an["collective_kinds"],
        "collective_counts": an["collective_counts"],
        "memory_analysis": an["memory_analysis"],
        "model_flops": mf,
        "useful_flops_ratio": mf / hlo_flops if hlo_flops else 0,
        "roofline_fraction": ideal_s / bound if bound > 0 else 0.0,
        "n_params": n_params, "n_active_params": n_active,
        "roofline": terms, "dominant": dominant,
    }


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    rank 0, for the duration (a fake group of that size already up is
    used as it is). Raises if a real group is up."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up: the dry-run "
                               "needs a fake one (run it in its own "
                               "process)")
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a fake group of {dist.get_world_size()} "
                               f"ranks is up, not {world_size}")
        yield
        return
    import torch.testing._internal.distributed.fake_pg as fake_pg
    import torch.distributed._tools.fake_collectives  # noqa: F401
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             device=None) -> Dict[str, Any]:
    """Analyse one production cell as rank 0 of a fake group of the
    mesh's size and write ``{arch}__{shape}__{mesh}.json`` to
    ``out_dir``."""
    dev = resolve_device(device)
    mshape, _ = PRODUCTION_MESHES[multi_pod]
    with fake_process_group(math.prod(mshape)):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        result = analyse_cell(get_config(arch), SHAPES[shape_name], mesh,
                              dev)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{result['mesh']}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cells = []
    if args.all:
        for arch in REGISTRY:
            for shape_name, shape in SHAPES.items():
                if shape_applicable(get_config(arch), shape):
                    cells.append((arch, shape_name))
    else:
        cells.append((args.arch, args.shape))

    failures = 0
    for arch, shape_name in cells:
        try:
            r = run_cell(arch, shape_name, args.multi_pod, args.out,
                         args.device)
            print(f"OK  {arch:24s} {shape_name:12s} {r['mesh']:20s} "
                  f"trace={r['trace_s']:6.1f}s "
                  f"flops={r['hlo_flops']:.3e} bytes={r['hlo_bytes']:.3e} "
                  f"coll={r['collective_bytes']:.3e} "
                  f"dom={r['dominant']} "
                  f"roofline={r['roofline_fraction']:.3f} "
                  f"useful={r['useful_flops_ratio']:.3f}", flush=True)
            print(f"    memory_analysis: {r['memory_analysis']}", flush=True)
        except Exception:
            failures += 1
            print(f"FAIL {arch} {shape_name}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
