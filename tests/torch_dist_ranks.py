"""The port's side of ``tests/test_torch_distributed.py``: jobs run on
gloo ranks on the CPU, one process a rank, which write what they
computed (rank 0, as numpy arrays) for the test to hold against the
reference's run.

    python tests/torch_dist_ranks.py port8 <dir>   # spawns 8 ranks
    python tests/torch_dist_ranks.py port4 <dir>   # spawns 4 ranks
    python tests/torch_dist_ranks.py dryrun8 <dir> # spawns 8 ranks
    python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        tests/torch_dist_ranks.py train <dir> <launch.train flags...>

``<dir>`` holds ``inputs.npz`` (the reference's parameters and the
inputs, written by the test; ``dryrun8`` reads none) and receives
``<job>.npz``. The ranks meet
through a ``file://`` store in ``<dir>`` (the ``train`` job through the
launcher's own rendezvous). Imports no JAX: this module is a helper of
the test, which pytest does not collect.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (init_process_group,  # noqa: E402
                                     make_host_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.param import (PartitionSpec,  # noqa: E402
                                      ShardingRules, placements, tree_leaves)
from repro_torch.models.sharding_ctx import (LocalShard,  # noqa: E402
                                             axis_index, axis_rules,
                                             distribute, distribute_leaf,
                                             mesh_shape_dict)
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.runtime import HostFailure, Supervisor  # noqa: E402
from repro_torch.runtime.pipeline import bubble_fraction, pipeline  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

# (name, arch, MoE overrides): the two expert-parallel branches on (2,4)
MOE_CASES = (
    ("ep", "granite-moe-3b-a800m", {"capacity_factor": 32.0}),
    ("ep2d", "qwen3-moe-235b-a22b", {"capacity_factor": 32.0, "pad_to": 8}),
)
# the 2-D EP case placed under the dry-run's 2-D EP serving rules (its
# experts stationary, one a rank), and the batch those rules are taken at
EP2D_STATIONARY = MOE_CASES[1]
EP2D_BATCH = 4
# the dry-run's (2,4) cells, at ``.reduced()`` and batch 4 x 64: (arch,
# shape name, kind); the name picks the reference's rules
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", "train"),
                ("qwen2.5-3b", "prefill_32k", "prefill"),
                ("qwen2.5-3b", "decode_32k", "decode"),
                ("gemma3-1b", "train_4k", "train"),
                ("granite-moe-3b-a800m", "train_4k", "train"),
                ("mamba2-780m", "train_4k", "train"),
                ("zamba2-2.7b", "train_4k", "train"),
                ("whisper-small", "train_4k", "train"),
                ("zamba2-2.7b", "decode_32k", "decode"))
DRYRUN_BATCH, DRYRUN_SEQ = 4, 64
TRAIN_ARCH = "qwen2.5-3b"
QROWS_HEADS = 6             # heads that do not divide a 4-way "model" axis
DECODE_BATCH, DECODE_STEPS = 4, 4
# the SSM, hybrid and encoder-decoder families held on (2,4) against the
# mesh-free port: the train step, prefill and FAMILY_STEPS decode steps
FAMILY_ARCHS = ("mamba2-780m", "zamba2-2.7b", "whisper-small")
FAMILY_STEPS = 3
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 5}
PIPE = {"n_stages": 4, "n_micro": 6, "mb": 2, "d": 8}


@contextlib.contextmanager
def one_rank_mesh(device="cpu"):
    """A (1,1) mesh over a one-rank group this process starts (and ends
    on leaving), gloo on the CPU, NCCL on the card."""
    started = init_process_group(device)
    try:
        yield make_host_mesh(1, 1, device=device)
    finally:
        if started:
            dist.destroy_process_group()


def moe_config(arch, overrides):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **overrides))


def flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def unflat(items, prefix):
    """The nested dict under ``prefix/`` of a flat dict."""
    root = {}
    for key, val in items.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _np(x):
    x = whole(x).detach()
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _own_storage(x) -> bool:
    """A DTensor's shard (or a plain tensor) holds a storage of its own
    size, not a view that keeps a whole tensor alive."""
    local = x.to_local() if hasattr(x, "to_local") else x
    return local.untyped_storage().nbytes() == \
        local.numel() * local.element_size()


def _ce_only(model, mesh):
    """The train loss without its aux term (the EP paths' aux averages
    per-shard statistics by design, as the reference's does)."""
    def loss_fn(params, batch):
        logits, _ = model.forward(params, batch, mesh=mesh, remat=False)
        ce, _ = tstep.cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce}
    return loss_fn


# -- jobs ----------------------------------------------------------------------


def job_port8(rank, workdir, inp):
    """The (2,4) mesh paths against the mesh-free port on the same
    weights: MoE expert parallelism, the sharded train step, a sharded
    save, prefill and decode over the mesh (and under the decode rules),
    the query-row split of heads that do not divide "model", the
    vocabulary-parallel loss; the pipeline on (4,2) ("pod","data");
    compressed_psum over 8 ranks."""
    out = {}
    mesh = make_host_mesh(2, 4, device="cpu")
    for name, arch, kw in MOE_CASES:
        cfg = moe_config(arch, kw)
        model = build_model(cfg)
        params = convert.params_from_numpy(unflat(inp, f"{name}_params"),
                                           "cpu")
        toks = torch.from_numpy(inp[f"{name}_tokens"])
        got, _ = model.forward(params, {"tokens": toks}, mesh=mesh)
        free, _ = model.forward(params, {"tokens": toks})
        sharded = convert.sharded_from_numpy(
            unflat(inp, f"{name}_params"), mesh,
            model.param_specs(ShardingRules(),
                              mesh_shape_dict(mesh)))
        dt, _ = model.forward(sharded, {"tokens": toks}, mesh=mesh)
        out[f"{name}_logits"] = _np(dt)
        out[f"{name}_plain_logits"] = _np(got)
        out[f"{name}_free_logits"] = _np(free)
        batch = {"tokens": toks, "labels": toks}
        (l_mesh, _), g_mesh = tstep.value_and_grad(
            _ce_only(model, mesh), sharded, batch, mesh)
        (l_free, _), g_free = tstep.value_and_grad(
            _ce_only(model, None), params, batch)
        out[f"{name}_ce"] = np.array([float(l_mesh), float(l_free)])
        out[f"{name}_grad_rel"] = np.array(
            [_rel(whole(a), b) for a, b in zip(tree_leaves(g_mesh),
                                                tree_leaves(g_free))])
        out[f"{name}_grad_placed"] = np.array(all(
            hasattr(g, "placements") and g.placements == p.placements
            for g, p in zip(tree_leaves(g_mesh), tree_leaves(sharded))))
        if name == "ep":    # serving over the mesh: prefill, 2 decodes
            pf, caches = model.prefill(sharded, {"tokens": toks}, skv=20,
                                       mesh=mesh)
            pf0, caches0 = model.prefill(params, {"tokens": toks}, skv=20)
            steps, steps0 = [pf], [pf0]
            for i in range(2):
                nxt = {"tokens": toks[:, i:i + 1],
                       "pos": torch.full((toks.shape[0],), 16 + i,
                                         dtype=torch.int32)}
                lg, caches = model.decode_step(sharded, caches, nxt,
                                               mesh=mesh)
                lg0, caches0 = model.decode_step(params, caches0, nxt)
                steps.append(lg)
                steps0.append(lg0)
            out["serve_logits"] = np.stack([_np(s) for s in steps])
            out["serve_free_logits"] = np.stack([_np(s) for s in steps0])
            out["serve_caches_same"] = np.array(all(
                torch.equal(whole(a), b) for a, b in zip(
                    tree_leaves(caches), tree_leaves(caches0))))

    out.update(_ep2d_stationary(mesh, inp))
    out.update(_query_rows(mesh, inp))
    for arch in FAMILY_ARCHS:
        out.update(_family(mesh, inp, arch))
    out.update(_decode_rules(mesh, inp))
    out.update(_vocab_parallel_loss(mesh, rank))

    # the sharded train step against the mesh-free step
    cfg = get_config(TRAIN_ARCH).reduced()
    model = build_model(cfg)
    placed = tstep.init_state(model, 0, device="cpu", mesh=mesh)
    drawn = tstep.init_state(model, 0, device="cpu")
    out["init_same"] = np.array(all(
        torch.equal(whole(a), b) for a, b in zip(tree_leaves(placed),
                                                 tree_leaves(drawn))))
    out["init_own_storage"] = np.array(all(
        _own_storage(v) for v in tree_leaves(placed)))
    del placed, drawn
    np_state = unflat(inp, "train_state")
    specs = tstep.state_specs(model, mesh)
    batch = {k: torch.from_numpy(inp[f"train_{k}"])
             for k in ("tokens", "labels")}
    opt_cfg = OptimizerConfig(**TRAIN_OPT)
    state = convert.sharded_from_numpy(np_state, mesh, specs)
    new, m = tstep.make_train_step(model, opt_cfg, mesh=mesh,
                                   remat=True)(state, batch)
    plain = convert.state_from_numpy(np_state, "cpu")
    new0, m0 = tstep.make_train_step(model, opt_cfg, remat=True)(plain,
                                                                 batch)
    for k in ("loss", "grad_norm"):
        out[f"train_{k}"] = np.array([float(m[k]), float(m0[k])])
    out.update({f"train_new/{k}": _np(v)
                for k, v in flat(new["params"]).items()})
    out.update({f"train_new0/{k}": _np(v)
                for k, v in flat(new0["params"]).items()})
    out["train_step"] = np.array(int(whole(new["opt"]["step"])))
    out["train_sharded"] = np.array(all(
        hasattr(v, "placements") for v in tree_leaves(new["params"])))
    loss_fn = tstep.make_loss_fn(model, remat=True)
    (_, _), g = tstep.value_and_grad(
        tstep.make_loss_fn(model, mesh=mesh, remat=True),
        convert.sharded_from_numpy(np_state["params"], mesh,
                                   specs["params"]), batch, mesh)
    (_, _), g0 = tstep.value_and_grad(   # (the step updated ``plain``)
        loss_fn, convert.params_from_numpy(np_state["params"], "cpu"), batch)
    out["train_grad_rel"] = np.array(
        [_rel(whole(a), b) for a, b in zip(tree_leaves(g),
                                            tree_leaves(g0))])
    out.update({f"train_grad/{k}": _np(v) for k, v in flat(g).items()})
    out.update({f"train_grad0/{k}": _np(v) for k, v in flat(g0).items()})

    # the supervisor over sharded state: a failure on rank 3 alone, before
    # step 2, is agreed by every rank, which all restore step 2 together
    failed = []

    def injector(step):
        if rank == 3 and step == 2 and not failed:
            failed.append(step)
            raise HostFailure()

    sup = Supervisor(Checkpointer(os.path.join(workdir, "sup_ckpt")),
                     checkpoint_every=1, device="cpu", mesh=mesh,
                     spec_tree=specs)
    state, hist = sup.run(convert.sharded_from_numpy(np_state, mesh, specs),
                          lambda s: batch, tstep.make_train_step(
                              model, opt_cfg, mesh=mesh), 0, 4,
                          failure_injector=injector)
    mine = [(h["step"], "restart" in h) for h in hist]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out["sup_history"] = np.array(mine)
    out["sup_agree"] = np.array(all(h == mine for h in every))
    out["sup_sharded"] = np.array(all(
        hasattr(v, "placements") for v in tree_leaves(state["params"])))

    # a sharded save, to be restored on (1,4)
    Checkpointer(os.path.join(workdir, "port_ckpt")).save(
        3, {"params": convert.sharded_from_numpy(
            np_state["params"], mesh, specs["params"])}, blocking=True)

    # the pipeline: 4 stages over "pod", 6 microbatches
    from torch.distributed.device_mesh import init_device_mesh
    mesh42 = init_device_mesh("cpu", (PIPE["n_stages"], 2),
                              mesh_dim_names=("pod", "data"))
    pw = torch.from_numpy(inp["pipe_w"]).requires_grad_()
    pb = torch.from_numpy(inp["pipe_b"]).requires_grad_()
    x = torch.from_numpy(inp["pipe_x"])

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    got = pipeline(stage, {"w": pw, "b": pb}, x, mesh42, axis="pod")
    gw, gb = torch.autograd.grad((got ** 2).sum(), [pw, pb])
    # each stage holds its own slice's gradient: sum them over the stages
    for gr in (gw, gb):
        dist.all_reduce(gr, group=mesh42.get_group("pod"))
    out["pipe_out"] = got.detach().numpy()
    out["pipe_gw"], out["pipe_gb"] = gw.numpy(), gb.numpy()
    out["pipe_bubble"] = np.array(bubble_fraction(6, 4))
    out.update(_pipeline_sharded(mesh42, inp, stage, got, {"w": gw,
                                                           "b": gb}))

    # compressed_psum: EF-int8 draws of each rank, reduced over the
    # "data" axis of an (8,1) mesh (every rank) and of the (2,4) mesh
    world = dist.get_world_size()
    g = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(
        (3, 5)).astype(np.float32))
    q, s, _ = compression.ef_quantize(g, torch.zeros_like(g))
    out["psum_all"] = compression.compressed_psum(
        {"g": q}, {"g": s}, "data", world,
        mesh=make_host_mesh(world, 1, device="cpu"))["g"].numpy()
    out["psum_data"] = compression.compressed_psum(
        {"g": q}, {"g": s}, "data", 2, mesh=mesh)["g"].numpy()
    return out


def _ep2d_stationary(mesh, inp):
    """``EP2D_STATIONARY`` on (2,4) with its parameters placed under the
    dry-run's 2-D EP serving rules (``sharding_rules_for("decode_32k",
    ..., ep2d=True)``: the experts over ("data", "model"), one a rank):
    whether each rank's expert block is rows ``[mine]`` of the whole
    weight; the forward logits, beside those of the same mesh's gather
    path (the decode rules without the override, whose experts lie over
    "model" alone) and the mesh-free port's; prefill and two decode
    steps; the gradient of the CE loss and its placements."""
    from repro_torch.launch import dryrun
    name, arch, kw = EP2D_STATIONARY
    cfg = moe_config(arch, kw)
    model = build_model(cfg)
    ms = mesh_shape_dict(mesh)
    params = convert.params_from_numpy(unflat(inp, f"{name}_params"), "cpu")
    toks = torch.from_numpy(inp[f"{name}_tokens"])
    rules = dryrun.sharding_rules_for("decode_32k", EP2D_BATCH, ms,
                                      ep2d=True)
    gather_rules = dryrun.sharding_rules_for("decode_32k", EP2D_BATCH, ms)
    mine = axis_index(mesh, ("data", "model"))
    out = {}
    with axis_rules(rules, ms):
        placed = distribute(params, mesh, model.param_specs(rules, ms))
        experts = placed["layers"]["moe"]
        own = all(
            tuple(experts[n].placements) == (Shard(1), Shard(1)) and
            torch.equal(experts[n].to_local(),
                        params["layers"]["moe"][n][:, mine:mine + 1])
            for n in ("w1", "w3", "w2"))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, own)
        out["ep2s_own_block"] = np.array(every)
        got, _ = model.forward(placed, {"tokens": toks}, mesh=mesh)
        gather, _ = model.forward(
            distribute(params, mesh, model.param_specs(gather_rules, ms)),
            {"tokens": toks}, mesh=mesh)
        free, _ = model.forward(params, {"tokens": toks})
        out["ep2s_logits"] = _np(got)
        out["ep2s_gather_logits"] = _np(gather)
        out["ep2s_free_logits"] = _np(free)

        pf, caches = model.prefill(placed, {"tokens": toks}, skv=20,
                                   mesh=mesh)
        pf0, caches0 = model.prefill(params, {"tokens": toks}, skv=20)
        steps, steps0 = [pf], [pf0]
        for i in range(2):
            nxt = {"tokens": toks[:, i:i + 1],
                   "pos": torch.full((toks.shape[0],), 16 + i,
                                     dtype=torch.int32)}
            lg, caches = model.decode_step(placed, caches, nxt, mesh=mesh)
            lg0, caches0 = model.decode_step(params, caches0, nxt)
            steps.append(lg)
            steps0.append(lg0)
        out["ep2s_serve_logits"] = np.stack([_np(t) for t in steps])
        out["ep2s_serve_free_logits"] = np.stack([_np(t) for t in steps0])

        batch = {"tokens": toks, "labels": toks}
        (_, _), g = tstep.value_and_grad(_ce_only(model, mesh), placed,
                                         batch, mesh)
    (_, _), g0 = tstep.value_and_grad(_ce_only(model, None), params, batch)
    out["ep2s_grad_rel"] = np.array(
        [_rel(whole(a), c) for a, c in zip(tree_leaves(g), tree_leaves(g0))])
    out["ep2s_grad_placed"] = np.array(all(
        hasattr(a, "placements") and a.placements == p.placements
        for a, p in zip(tree_leaves(g), tree_leaves(placed))))
    return out


def _pipeline_sharded(mesh42, inp, stage, want, want_grads):
    """The pipeline on stage parameters placed as the reference shards
    them (``Shard(0)`` over "pod", ``Replicate`` over "data"), traced:
    its outputs and gradients against the replicated run's (``want``;
    ``want_grads`` summed over the stages, so row s is stage s's
    gradient), the gradients' placements, the collectives of the forward
    and backward; and the error of a leaf whose leading dimension is not
    the number of stages."""
    from repro_torch.launch import dryrun
    spec = PartitionSpec("pod")
    placed = {k: distribute_leaf(torch.from_numpy(inp[f"pipe_{k}"]), mesh42,
                                 spec).requires_grad_() for k in ("w", "b")}
    x = torch.from_numpy(inp["pipe_x"])

    def run():
        got = pipeline(stage, placed, x, mesh42, axis="pod")
        return got, torch.autograd.grad((got ** 2).sum(),
                                        [placed["w"], placed["b"]])

    (got, grads), an = dryrun.trace(run, ())
    s = mesh42.get_local_rank("pod")
    same = torch.equal(got, want) and all(
        tuple(g.placements) == (Shard(0), Replicate()) and
        torch.equal(g.to_local()[0], want_grads[k][s])
        for k, g in zip(("w", "b"), grads))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, same)
    out = {"pipe_sharded_same": np.array(every),
           "pipe_sharded_out": got.detach().numpy(),
           "pipe_sharded_kinds": np.array(json.dumps(an["collective_kinds"]))}
    w = torch.from_numpy(inp["pipe_w"])
    for name, bad in (("shape", w[:3]), ("placement", distribute_leaf(
            w, mesh42, PartitionSpec(None, "data")))):
        try:
            pipeline(stage, {"w": bad, "b": placed["b"]}, x, mesh42,
                     axis="pod")
            out[f"pipe_bad_{name}"] = np.array("")
        except ValueError as exc:
            out[f"pipe_bad_{name}"] = np.array(str(exc))
    return out


def _query_rows(mesh, inp):
    """qwen2.5-3b reduced with 6 heads, which do not divide the 4-way
    "model" axis: each rank takes its block of the query rows (the
    reference's ``attn_q_seq`` branch). The (2,4) forward and train step
    against the mesh-free ones, from the same draw."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                              n_heads=QROWS_HEADS)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(inp[f"train_{k}"])
             for k in ("tokens", "labels")}
    state = tstep.init_state(model, 0, device="cpu", mesh=mesh)
    plain = tstep.init_state(model, 0, device="cpu")
    attn0 = {k: LocalShard.of(v, mesh)[0]
             for k, v in state["params"]["layers"]["attn"].items()}
    split = transformer._attn_split(attn0, cfg, batch["tokens"].shape[1],
                                    mesh)
    got, _ = model.forward(state["params"], {"tokens": batch["tokens"]},
                           mesh=mesh)
    want, _ = model.forward(plain["params"], {"tokens": batch["tokens"]})
    out = {"qrows_split": np.array(str(split.kind)),
           "qrows_logits": _np(got), "qrows_free_logits": _np(want)}
    old = {k: _np(v).copy() for k, v in flat(plain["params"]).items()}
    (_, _), g = tstep.value_and_grad(
        tstep.make_loss_fn(model, mesh=mesh, remat=True), state["params"],
        batch, mesh)
    (_, _), g0 = tstep.value_and_grad(tstep.make_loss_fn(model, remat=True),
                                      plain["params"], batch)
    out["qrows_grad_rel"] = np.array(
        [_rel(whole(a), b) for a, b in zip(tree_leaves(g), tree_leaves(g0))])
    opt_cfg = OptimizerConfig(**TRAIN_OPT)
    new, m = tstep.make_train_step(model, opt_cfg, mesh=mesh, remat=True)(
        state, batch)
    new0, m0 = tstep.make_train_step(model, opt_cfg, remat=True)(plain,
                                                                 batch)
    for k in ("loss", "grad_norm"):
        out[f"qrows_{k}"] = np.array([float(m[k]), float(m0[k])])
    out["qrows_update_rel"] = _update_rel(old, new["params"], new0["params"])
    return out


def _update_rel(old, new, new0):
    """Each leaf's update (``new`` from ``old``) against the mesh-free
    update (``new0``), norm-relative."""
    new, new0 = flat(new), flat(new0)
    return np.array([
        float(np.linalg.norm((_np(new[k]) - old[k]) - (_np(new0[k]) - old[k]))
              / max(np.linalg.norm(_np(new0[k]) - old[k]), 1e-30))
        for k in sorted(old)])


def family_batch(cfg, tokens):
    """The train batch of ``tokens`` (B, S+1), with whisper's stub frames
    (drawn from seed 3, alike on every rank)."""
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    if cfg.enc_dec:
        rng = np.random.default_rng(3)
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (tokens.shape[0], cfg.n_frames, cfg.d_model)).astype(
                np.float32)).to(torch.bfloat16)
    return batch


def _family(mesh, inp, arch):
    """``arch`` reduced on (2,4) against the mesh-free port from one draw
    (``init_state``'s): the forward logits, the gradient of the loss and
    one train step, prefill and ``FAMILY_STEPS`` decode steps on sharded
    parameters, and whether each cache comes back under its spec's
    placements as this rank's block. zamba2's reduced stack is chaotic
    (its second shared attention turns a 1e-4 difference of the loss's
    gradient into 2e-3): its train step is taken on its first group and
    shared block, as ``tests/test_torch_models.py`` holds it group by
    group."""
    key = f"fam_{arch}"
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    toks = np.concatenate([inp["train_tokens"], inp["train_labels"][:, -1:]],
                          1)
    batch = family_batch(cfg, torch.from_numpy(toks))
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    state = tstep.init_state(model, 0, device="cpu", mesh=mesh)
    plain = tstep.init_state(model, 0, device="cpu")
    got, _ = model.forward(state["params"], fwd, mesh=mesh)
    want, _ = model.forward(plain["params"], fwd)
    out = {f"{key}_logits": _np(got), f"{key}_free_logits": _np(want)}

    b, s = batch["tokens"].shape
    skv = s + FAMILY_STEPS
    specs = model.cache_specs(b, skv, ShardingRules(), mesh_shape_dict(mesh))
    runs = {}
    # sharded parameters, plain ones every rank holds alike (each rank
    # computes whole over "model", its caches cut to their specs'
    # blocks), and no mesh
    for name, params, m in (("serve", state["params"], mesh),
                            ("plain_serve", plain["params"], mesh),
                            ("serve_free", plain["params"], None)):
        lg, caches = model.prefill(params, fwd, skv=skv, mesh=m)
        steps, placed = [lg], []
        for i in range(FAMILY_STEPS):
            placed.append(m is None or _under_specs(caches, specs, m))
            nxt = {"tokens": batch["tokens"][:, i:i + 1],
                   "pos": torch.full((b,), s + i, dtype=torch.int32)}
            lg, caches = model.decode_step(params, caches, nxt, mesh=m)
            steps.append(lg)
        placed.append(m is None or _under_specs(caches, specs, m))
        out[f"{key}_{name}_logits"] = np.stack([_np(t) for t in steps])
        out[f"{key}_{name}_placed"] = np.array(placed)
        runs[name] = [whole(c).double() for c in tree_leaves(caches)]
    for name in ("serve", "plain_serve"):
        out[f"{key}_{name}_caches_rel"] = np.array(
            [_rel(a, c) for a, c in zip(runs[name], runs["serve_free"])])

    old = {k: _np(v).copy() for k, v in flat(plain["params"]).items()}
    (_, _), g = tstep.value_and_grad(
        tstep.make_loss_fn(model, mesh=mesh, remat=True), state["params"],
        batch, mesh)
    (_, _), g0 = tstep.value_and_grad(tstep.make_loss_fn(model, remat=True),
                                      plain["params"], batch)
    out[f"{key}_grad_rel"] = np.array(
        [_rel(whole(a), c) for a, c in zip(tree_leaves(g), tree_leaves(g0))])
    out[f"{key}_grad_placed"] = np.array(all(
        hasattr(a, "placements") and a.placements == p.placements
        for a, p in zip(tree_leaves(g), tree_leaves(state["params"]))))
    if cfg.shared_attn_every:
        cfg = dataclasses.replace(cfg, n_layers=cfg.shared_attn_every)
        model = build_model(cfg)
        state = tstep.init_state(model, 0, device="cpu", mesh=mesh)
        plain = tstep.init_state(model, 0, device="cpu")
        old = {k: _np(v).copy() for k, v in flat(plain["params"]).items()}
    out[f"{key}_step_layers"] = np.array(cfg.n_layers)
    opt_cfg = OptimizerConfig(**TRAIN_OPT)
    new, m = tstep.make_train_step(model, opt_cfg, mesh=mesh, remat=True)(
        state, batch)
    new0, m0 = tstep.make_train_step(model, opt_cfg, remat=True)(plain,
                                                                 batch)
    for k in ("loss", "grad_norm"):
        out[f"{key}_{k}"] = np.array([float(m[k]), float(m0[k])])
    out[f"{key}_update_rel"] = _update_rel(old, new["params"],
                                           new0["params"])
    return out


def _decode_rules(mesh, inp):
    """qwen2.5-3b reduced under the dry-run's decode rules (``kv_seq`` on
    "model", no FSDP): prefill then four decode steps on (2,4) against
    the mesh-free ones, each rank's caches its spec's block; the
    collectives of one decode step, traced."""
    from repro_torch.launch import dryrun
    cfg = get_config(TRAIN_ARCH).reduced()
    model = build_model(cfg)
    ms = mesh_shape_dict(mesh)
    rules = dryrun.sharding_rules_for("decode_32k", DECODE_BATCH, ms)
    toks = torch.from_numpy(inp["train_tokens"])
    params = convert.params_from_numpy(unflat(inp, "train_state")["params"],
                                       "cpu")
    b, skv = toks.shape[0], toks.shape[1] + DECODE_STEPS
    out = {}
    with axis_rules(rules, ms):
        sharded = distribute(params, mesh, model.param_specs(rules, ms))
        specs = model.cache_specs(b, skv, rules, ms)
        logits, caches = model.prefill(sharded, {"tokens": toks}, skv=skv,
                                       mesh=mesh)
        logits0, caches0 = model.prefill(params, {"tokens": toks}, skv=skv)
        steps, steps0 = [logits], [logits0]
        for i in range(DECODE_STEPS):
            nxt = {"tokens": toks[:, i:i + 1],
                   "pos": torch.full((b,), toks.shape[1] + i,
                                     dtype=torch.int32)}
            if i == 0:
                (lg, caches), an = dryrun.trace(
                    lambda c, n: model.decode_step(sharded, c, n, mesh=mesh),
                    (caches, nxt))
                out["dec_collectives"] = np.array(json.dumps(
                    [an["collective_kinds"], an["collective_counts"]]))
            else:
                lg, caches = model.decode_step(sharded, caches, nxt,
                                               mesh=mesh)
            lg0, caches0 = model.decode_step(params, caches0, nxt)
            steps.append(lg)
            steps0.append(lg0)
        out["dec_placed"] = np.array(_under_specs(caches, specs, mesh))
    out["dec_block_bytes"] = np.array(
        tree_leaves(caches)[0].to_local()[0].nbytes)
    out["dec_logits"] = np.stack([_np(t) for t in steps])
    out["dec_free_logits"] = np.stack([_np(t) for t in steps0])
    for key, c, c0 in zip(("k", "v"), tree_leaves(caches),
                          tree_leaves(caches0)):
        out[f"dec_cache_{key}"] = _np(c)
        out[f"dec_free_cache_{key}"] = _np(c0)
    return out


def _under_specs(caches, specs, mesh) -> bool:
    """Each cache a DTensor under its spec's placements whose local
    tensor is its spec's block."""
    return all(tuple(c.placements) == tuple(placements(sp, mesh)) and
               list(c.to_local().shape) == _block_shape(c.shape, sp, mesh)
               for c, sp in zip(tree_leaves(caches), tree_leaves(specs)))


def _block_shape(shape, spec, mesh):
    local = list(shape)
    for i, p in enumerate(placements(spec, mesh)):
        if hasattr(p, "dim"):
            local[p.dim] //= mesh.size(i)
    return local


def _vocab_parallel_loss(mesh, rank):
    """``cross_entropy`` on bf16 logits split over the rows ("data") and
    the vocabulary ("model") against it on the whole logits: the CE and
    z-loss, and the gradient of a rank's loss / 8 on its block against
    the block of the whole loss's gradient."""
    rng = np.random.default_rng(7)
    whole_logits = torch.from_numpy((rng.standard_normal((4, 32, 512)) * 4)
                                    .astype(np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 512, (4, 32)).astype(np.int32))
    mask = torch.from_numpy((rng.random((4, 32)) < 0.8).astype(np.float32))
    spec = PartitionSpec("data", None, "model")
    placed = distribute_leaf(whole_logits, mesh, spec)
    local = placed.to_local().detach().requires_grad_()
    dt = DTensor.from_local(local, mesh, placed.placements, run_check=False)
    ce, zl = tstep.cross_entropy(dt, labels, mask)
    grad = torch.autograd.grad((ce + tstep.Z_LOSS_WEIGHT * zl) / 8, local)[0]
    x = whole_logits.detach().requires_grad_()
    ce0, zl0 = tstep.cross_entropy(x, labels, mask)
    grad0 = torch.autograd.grad(ce0 + tstep.Z_LOSS_WEIGHT * zl0, x)[0]
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    block = grad0[d * 2:(d + 1) * 2, :, m * 128:(m + 1) * 128]
    rel = float((grad.double() - block.double()).norm()
                / block.double().norm())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rel)
    return {"ce_terms": np.array([float(ce), float(ce0), float(zl),
                                  float(zl0)]),
            "ce_grad_rel": np.array(every)}


def job_port4(rank, workdir, inp):
    """The elastic restore: the port's (2,4) checkpoint and the
    reference's, restored onto a (1,4) mesh."""
    out = {}
    mesh = make_host_mesh(1, 4, device="cpu")
    model = build_model(get_config(TRAIN_ARCH).reduced())
    specs = {"params": model.param_specs(ShardingRules(),
                                         mesh_shape_dict(mesh))}
    want = flat(unflat(inp, "train_state")["params"])
    for name in ("port_ckpt", "ref_ckpt"):
        step, tree = Checkpointer(os.path.join(workdir, name)).restore(
            mesh=mesh, spec_tree=specs)
        got = flat(tree["params"])
        out[f"{name}_step"] = np.array(step)
        out[f"{name}_same"] = np.array(
            sorted(got) == sorted(want) and all(
                np.array_equal(_np(got[k]), want[k]) for k in want))
        out[f"{name}_sharded"] = np.array(
            [str(v.placements) for v in got.values()])
        out[f"{name}_own_storage"] = np.array(all(
            _own_storage(v) for v in got.values()))
    return out


def dryrun_cell(arch, name, kind):
    """(reduced config, shape) of a ``DRYRUN_CELLS`` entry."""
    from repro_torch.configs import ShapeConfig
    return get_config(arch).reduced(), ShapeConfig(name, DRYRUN_SEQ,
                                                   DRYRUN_BATCH, kind)


def job_dryrun8(rank, workdir, inp):
    """The dry-run's trace of each ``DRYRUN_CELLS`` step on real tensors
    (zeros) over the (2,4) mesh: rank 0's FLOPs, traffic, collectives and
    memory, as JSON."""
    from repro_torch.launch import dryrun
    mesh = make_host_mesh(2, 4, device="cpu")
    out = {f"{arch}|{name}": dryrun.trace_cell(
        *dryrun_cell(arch, name, kind), mesh, torch.device("cpu"))
        for arch, name, kind in DRYRUN_CELLS}
    return {"json": np.array(json.dumps(out))}


def job_train(rank, workdir, argv):
    """``launch.train.main`` under the launcher; rank 0 writes the
    losses."""
    from repro_torch.launch import train as launch_train
    start, _, hist = launch_train.main(argv)
    if rank == 0:
        with open(os.path.join(workdir, "train.json"), "w") as fh:
            json.dump({"start": start, "losses": [h["loss"] for h in hist
                                                  if "loss" in h]}, fh)


JOBS = {"port8": (8, job_port8), "port4": (4, job_port4),
        "dryrun8": (8, job_dryrun8)}


def _rank(rank, world, job, workdir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, job + '.store')}",
        rank=rank, world_size=world)
    try:
        path = os.path.join(workdir, "inputs.npz")
        inp = dict(np.load(path)) if os.path.exists(path) else {}
        out = JOBS[job][1](rank, workdir, inp)
        if rank == 0:
            np.savez(os.path.join(workdir, f"{job}.npz"), **out)
    finally:
        dist.destroy_process_group()


def main(argv):
    job, workdir = argv[0], argv[1]
    if job == "train":
        torch.set_num_threads(1)
        job_train(int(os.environ.get("RANK", 0)), workdir, argv[2:])
        return
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(JOBS[job][0], job, workdir),
             nprocs=JOBS[job][0])


if __name__ == "__main__":
    main(sys.argv[1:])
