"""The port's training substrate, case for case with
``tests/test_train_infra.py`` (the optimizer schedule, microbatching,
checkpoint/restore, the fault-tolerant supervisor, the straggler
watchdog, the elastic mesh policy, EF-int8 convergence parity), plus
checkpoints carried between the two packages and ``launch.train``.

Checkpoints share the reference's on-disk layout: a checkpoint written
by either package restores in the other bit for bit, and for the
float32/int32 leaves of a train state both write the same manifest and
the same ``.npy`` bytes.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import test_train_infra as jti
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.runtime import HostFailure as RefHostFailure
from repro.runtime import Supervisor as RefSupervisor
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.param import tree_leaves
from repro_torch.optim.optimizer import OptimizerConfig, schedule
from repro_torch.runtime import (HostFailure, StragglerWatchdog, Supervisor,
                                 elastic_mesh_shape)
from repro_torch.train.step import init_state, make_train_step


def small_setup(microbatches=1):
    """``test_train_infra.small_setup`` on the port, on the CPU."""
    cfg = get_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    state = init_state(model, 0, device="cpu")
    opt = OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=50)
    step = make_train_step(model, opt, remat=False,
                           microbatches=microbatches)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, noise=0.0))

    def batch_at(s):
        return {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}

    return model, state, step, batch_at


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def test_loss_decreases():
    _, state, step, batch_at = small_setup()
    losses = []
    for s in range(25):
        state, m = step(state, batch_at(s))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_schedule_warmup_and_decay():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(schedule(cfg, torch.tensor(100))) == pytest.approx(
        cfg.min_lr_ratio)


def test_microbatch_accumulation_matches_full_batch():
    _, state, step1, batch_at = small_setup(microbatches=1)
    _, _, step4, _ = small_setup(microbatches=4)
    b = batch_at(0)
    # the step updates its state in place: each run takes its own copy
    s1, m1 = step1(_clone(state), b)
    s4, m4 = step4(_clone(state), b)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    w1 = tree_leaves(s1["params"])[0]
    w4 = tree_leaves(s4["params"])[0]
    np.testing.assert_allclose(w1.numpy(), w4.numpy(), atol=1e-3)


def test_checkpoint_roundtrip(tmp_path):
    _, state, step, batch_at = small_setup()
    state, _ = step(state, batch_at(0))
    ck = Checkpointer(str(tmp_path), keep_n=2)
    ck.save(1, state, blocking=True)
    got_step, tree = ck.restore(device="cpu")
    assert got_step == 1
    for a, b in zip(tree_leaves(state), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_snapshot_is_a_copy(tmp_path):
    """An async save holds the tree as it was when saved, though the
    next step writes the live tensors in place."""
    _, state, step, batch_at = small_setup()
    ck = Checkpointer(str(tmp_path))
    before = _clone(state)
    ck.save(0, state)
    state, _ = step(state, batch_at(0))
    ck.wait()
    for a, b in zip(tree_leaves(before), tree_leaves(ck.restore(
            device="cpu")[1])):
        assert torch.equal(a, b)


def test_checkpoint_retention_and_atomicity(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.ones((2,)) * s}, blocking=True)
    assert ck.steps() == [3, 4]
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ck.restore(mesh=object(), device="cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(device="cpu")


def _history(hist):
    """A supervisor history without its wall times: (step, restart) of
    each entry."""
    return [(h["step"], h.get("restart")) for h in hist]


class _BlockingRefCheckpointer(RefCheckpointer):
    """The reference's checkpointer with every save written before it
    returns. The reference's ``Supervisor.run`` reads ``latest_step()``
    before it waits for a save in flight, so a failure that lands while
    the step-5 save is still writing restarts it from step 0; a blocking
    save leaves nothing in flight when a failure lands (the port's
    supervisor waits first)."""

    def save(self, step, tree, blocking=False):
        super().save(step, tree, blocking=True)


def test_supervisor_recovers_from_injected_failures(tmp_path):
    """The reference's case on the port, and its history equal to the
    reference supervisor's over the same failures (the reference's saves
    blocking: ``_BlockingRefCheckpointer``)."""
    def run(sup_cls, ck, state, step, batch_at, failure):
        kw = {"device": "cpu"} if sup_cls is Supervisor else {}
        sup = sup_cls(ck, checkpoint_every=5, **kw)
        fail_at = {7, 12}

        def injector(s):
            if s in fail_at:
                fail_at.remove(s)
                raise failure()

        return sup.run(state, batch_at, step, start_step=0, n_steps=20,
                       failure_injector=injector)

    _, state, step, batch_at = small_setup()
    ck = Checkpointer(str(tmp_path / "port"), keep_n=3)
    final, hist = run(Supervisor, ck, state, step, batch_at, HostFailure)
    steps_run = [h["step"] for h in hist if "dt" in h]
    assert max(steps_run) == 19
    restarts = [h for h in hist if "restart" in h]
    assert len(restarts) == 2
    assert ck.latest_step() == 20

    _, jstate, jstep, jbatch = jti.small_setup()
    jck = _BlockingRefCheckpointer(str(tmp_path / "ref"), keep_n=3)
    _, jhist = run(RefSupervisor, jck, jstate, jstep, jbatch, RefHostFailure)
    assert _history(hist) == _history(jhist)
    assert ck.steps() == jck.steps()
    for h, j in zip(hist, jhist):
        assert set(h) == set(j)


def test_straggler_watchdog():
    wd = StragglerWatchdog(alpha=0.5, threshold=2.0)
    for s in range(5):
        assert not wd.observe(s, 1.0)
    assert wd.observe(5, 5.0)      # flagged
    assert not wd.observe(6, 1.1)  # baseline not poisoned
    assert wd.flagged == [5]


def test_elastic_mesh_shape():
    assert elastic_mesh_shape(512, 16) == {"data": 32, "model": 16}
    assert elastic_mesh_shape(480, 16) == {"data": 30, "model": 16}
    with pytest.raises(ValueError):
        elastic_mesh_shape(8, 16)


def test_gradient_compression_convergence_parity():
    """EF-int8-compressed 2-shard training ~ full-precision training, on
    the reference's data."""
    from repro_torch.train.compression import (compression_ratio,
                                               ef_compress_tree,
                                               init_error_state)

    rng = np.random.default_rng(0)
    wtrue = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32))
    y = x @ wtrue

    def loss(w, xs, ys):
        return torch.mean((xs @ w - ys) ** 2)

    def grad(w, xs, ys):
        w = w.detach().requires_grad_()
        return torch.autograd.grad(loss(w, xs, ys), w)[0]

    def train(compressed):
        w = torch.zeros(8)
        err = [init_error_state({"w": w}) for _ in range(2)]
        lr = 0.05
        for _ in range(150):
            gs = []
            for shard in range(2):
                sl = slice(shard * 128, (shard + 1) * 128)
                gi = {"w": grad(w, x[sl], y[sl])}
                if compressed:
                    q, scale, err[shard] = ef_compress_tree(gi, err[shard])
                    gi = {"w": q["w"].to(torch.float32) * scale["w"]}
                gs.append(gi)
            w = w - lr * (gs[0]["w"] + gs[1]["w"]) / 2
        return float(loss(w, x, y))

    full = train(False)
    comp = train(True)
    assert comp < 1e-3, comp
    assert abs(comp - full) < 1e-3
    assert compression_ratio({"w": np.zeros((1000,))}) > 3.5


# -- checkpoints across the two packages ---------------------------------------


def _ref_state_after_one_step():
    _, state, step, batch_at = jti.small_setup()
    state, _ = step(state, batch_at(0))
    return jax.tree.map(np.asarray, state)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    np_state = _ref_state_after_one_step()
    RefCheckpointer(str(tmp_path)).save(3, np_state, blocking=True)
    step, tree = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert step == 3
    assert tree["opt"]["step"].dtype == torch.int32
    assert tree["opt"]["step"].shape == ()
    want = convert.state_from_numpy(np_state, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _, state, step, batch_at = small_setup()
    state, _ = step(state, batch_at(0))
    Checkpointer(str(tmp_path)).save(3, state, blocking=True)
    got_step, tree = RefCheckpointer(str(tmp_path)).restore()
    assert got_step == 3
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(state)):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_both_packages_write_the_same_bytes(tmp_path):
    """The same train state saved by each package: equal manifests and
    equal ``.npy`` files, leaf for leaf."""
    np_state = _ref_state_after_one_step()
    RefCheckpointer(str(tmp_path / "ref")).save(5, np_state, blocking=True)
    Checkpointer(str(tmp_path / "port")).save(
        5, convert.state_from_numpy(np_state, device="cpu"), blocking=True)
    ref_dir = tmp_path / "ref" / "step_00000005"
    port_dir = tmp_path / "port" / "step_00000005"
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    manifest = json.loads((ref_dir / "manifest.json").read_text())
    assert {m["dtype"] for m in manifest["leaves"].values()} == {
        "float32", "int32"}
    for name in os.listdir(ref_dir):
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes()


def test_bfloat16_leaves_travel_as_their_bits(tmp_path):
    """A bf16 leaf keeps its 16-bit patterns: the reference's save
    restores in the port, the port's in the port; the manifests name the
    dtype alike."""
    bits = np.random.default_rng(9).standard_normal((4, 5)).astype(
        ml_dtypes.bfloat16)
    RefCheckpointer(str(tmp_path / "ref")).save(
        1, {"k": jnp.asarray(bits)}, blocking=True)
    want = convert.params_from_numpy({"k": bits}, device="cpu")["k"]
    Checkpointer(str(tmp_path / "port")).save(1, {"k": want}, blocking=True)
    for where in ("ref", "port"):
        _, tree = Checkpointer(str(tmp_path / where)).restore(device="cpu")
        assert tree["k"].dtype == torch.bfloat16
        assert torch.equal(tree["k"].view(torch.int16),
                           want.view(torch.int16))
        manifest = json.loads(
            (tmp_path / where / "step_00000001" / "manifest.json")
            .read_text())
        assert manifest["leaves"]["k"]["dtype"] == "bfloat16"


# -- the entry point -----------------------------------------------------------


def test_launch_train_runs_then_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU: 30 steps (a checkpoint at 25 and
    at 30), then a resume to 40 that starts from step 30's state."""
    ckpt = str(tmp_path / "ck")
    args = ["--reduced", "--batch", "4", "--seq", "32", "--device", "cpu",
            "--ckpt-dir", ckpt]
    start, state, hist = launch_train.main(args + ["--steps", "30"])
    out = capsys.readouterr().out.splitlines()
    assert start == 0 and [h["step"] for h in hist] == list(range(30))
    assert out[0].startswith("arch=qwen2.5-3b N=") and \
        out[0].endswith("mesh=(1,1) devices=1")
    assert out[-1].startswith("steps 0->30: loss ")
    ck = Checkpointer(ckpt)
    assert ck.steps() == [25, 30]
    saved = ck.restore(30, device="cpu")[1]
    for a, b in zip(tree_leaves(saved), tree_leaves(state)):
        assert torch.equal(a, b)

    start, state, hist = launch_train.main(args + ["--steps", "40",
                                                   "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert start == 30 and hist[0]["step"] == 30
    assert "resumed from step 30" in out[1]
    assert out[-1].startswith("steps 30->40: loss ")
    assert ck.steps() == [25, 30, 40]
    assert int(state["opt"]["step"]) == 40
    assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("flags", [["--data-parallel", "2"],
                                   ["--model-parallel", "2"]])
def test_launch_train_over_a_mesh_raises(flags, tmp_path):
    """A mesh larger than the process group raises (one rank here;
    tests/test_torch_distributed.py runs the (2,4) mesh on 8 ranks)."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        launch_train.main(["--reduced", "--device", "cpu", "--ckpt-dir",
                           str(tmp_path)] + flags)
