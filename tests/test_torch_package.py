"""The port's package boundary.

``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything of
the JAX package (checked by parsing every source), importing the port
leaves ``jax`` out of ``sys.modules``, entry points default to the card
and raise without one, and a kernel build without ``nvcc`` raises rather
than falling back.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_no_jax_and_no_reference_package():
    srcs = _sources()
    assert len(srcs) > 20
    bad = []
    for path in srcs:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch, repro_torch.core, "
            "repro_torch.pim, repro_torch.serve, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.apps.bitmap_index, "
            "repro_torch.apps.bitweaving_db, repro_torch.apps.binary_lm, "
            "repro_torch.apps.bitfunnel, repro_torch.apps.bitsets, "
            "repro_torch.apps.masked_init, repro_torch.core.analog, "
            "repro_torch.core.ecc, repro_torch.core.timing_checker, "
            "repro_torch.pim.allocator, repro_torch.pim.store, "
            "repro_torch.pim.planner, repro_torch.pim.cluster, "
            "repro_torch.pim.optimizer, repro_torch.pim.faults, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.models.transformer, repro_torch.models.moe, "
            "repro_torch.models.ssm, repro_torch.serve.engine, "
            "repro_torch.launch.serve, repro_torch.data.pipeline, "
            "repro_torch.optim, repro_torch.optim.optimizer, "
            "repro_torch.train, repro_torch.train.step, "
            "repro_torch.train.compression, repro_torch.checkpoint, "
            "repro_torch.runtime, repro_torch.launch.train, "
            "repro_torch.launch.hloparse, repro_torch.launch.mesh, "
            "repro_torch.models.sharding_ctx, repro_torch.runtime.pipeline, "
            "repro_torch.launch.dryrun, repro_torch.examples, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.bitmap_analytics, "
            "repro_torch.examples.serve_decode, "
            "repro_torch.examples.train_lm; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.core import BulkBitwiseEngine
    from repro_torch.pim import AmbitRuntime
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AmbitRuntime(backend="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BulkBitwiseEngine(backend="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AmbitRuntime(backend="torch")
    assert AmbitRuntime(backend="cuda", device="cpu").device.type == "cpu"
    import numpy as np
    from repro_torch import convert
    from repro_torch.apps.bitfunnel import BitFunnelIndex
    from repro_torch.core import (AmbitDevice, AmbitSubarray, BitVector,
                                  pack_bits)
    from repro_torch.core.analog import tra_failure_rate
    from repro_torch.core.simulator import AmbitBank
    words = np.zeros(4, np.uint32)
    made = {  # entry point -> where its result lies
        "BitVector.zeros": lambda **kw: BitVector.zeros(40, **kw).data,
        "BitVector.ones": lambda **kw: BitVector.ones(40, **kw).data,
        "BitVector.from_bits": lambda **kw: BitVector.from_bits(
            np.ones(40, bool), **kw).data,
        "pack_bits": lambda **kw: pack_bits(np.ones(40, bool), **kw),
        "from_numpy_u32": lambda **kw: convert.from_numpy_u32(words, **kw),
        "bitvector_from_numpy": lambda **kw: convert.bitvector_from_numpy(
            words, 100, **kw).data,
        "AmbitSubarray": lambda **kw: AmbitSubarray(words=2, **kw).c_rows[1],
        "AmbitBank": lambda **kw: AmbitBank(
            subarrays=1, words=2, **kw).subarrays[0].c_rows[0],
        "AmbitDevice": lambda **kw: AmbitDevice(
            banks=1, subarrays=1, words=2, **kw).banks[0].subarrays[0]
        .t_rows["T0"],
        "ambit_sim engine": lambda **kw: BulkBitwiseEngine(
            "ambit_sim", **kw).and_(BitVector.ones(40, device="cpu"),
                                    BitVector.ones(40, device="cpu")).data,
        "BitFunnelIndex": lambda **kw: BitFunnelIndex(4, **kw).engine,
        "tra_failure_rate": lambda **kw: tra_failure_rate(
            0.1, n_trials=10, **kw),
    }
    for name, make in made.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        out = make(device="cpu")
        if hasattr(out, "device"):
            assert torch.device(out.device).type == "cpu", name


@pytest.mark.parametrize("entry", ["synthesize", "from_values",
                                   "column_from_numpy", "table_from_numpy"])
def test_bitweaving_entry_points_default_to_the_card(entry, monkeypatch):
    """Columns and tables compute where their planes lie, so they land on
    the card unless the caller names the CPU, and raise without a card."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.apps import bitweaving_db as bw
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    values = np.arange(40, dtype=np.uint32) % 16
    make = {
        "synthesize": lambda **kw: bw.TpchTable.synthesize(n_rows=40, **kw),
        "from_values": lambda **kw: bw.BitWeavingColumn.from_values(
            values, 4, **kw),
        "column_from_numpy": lambda **kw: convert.column_from_numpy(
            np.zeros((4, 2), np.uint32), 40, 4, **kw),
        "table_from_numpy": lambda **kw: convert.table_from_numpy(
            {"v": values}, columns=(("v", 4),), **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    made = make(device="cpu")
    cols = made.columns.values() if hasattr(made, "columns") else [made]
    assert all(c.planes.device.type == "cpu" for c in cols)


@pytest.mark.parametrize("entry", ["main", "BitLinear",
                                   "bitlinear_from_numpy"])
def test_binary_lm_entry_points_default_to_the_card(entry, monkeypatch):
    """The binary-LM example and its layer run on the card unless the
    caller names the CPU, and raise without a card."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.apps import binary_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.full((8, 256), 0.1, np.float32)
    make = {
        "main": lambda **kw: binary_lm.main(**kw),
        "BitLinear": lambda **kw: binary_lm.BitLinear(w, **kw),
        "bitlinear_from_numpy": lambda **kw: convert.bitlinear_from_numpy(
            w, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    if entry != "main":
        assert make(device="cpu").weight.device.type == "cpu"


@pytest.mark.parametrize("example", ["quickstart", "bitmap_analytics",
                                     "serve_decode", "train_lm"])
def test_examples_default_to_the_card(example, monkeypatch, tmp_path):
    """Each example of ``repro_torch.examples`` runs on the card unless
    ``--device`` names another, and raises without a card before it
    does any work (``tests/test_torch_examples.py`` runs each on the
    CPU)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{example}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt-dir", str(tmp_path)] if example == "train_lm" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv + ["--device", "cuda"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("entry", ["Model.init", "init_cache",
                                   "filter_documents", "FilteredSyntheticLM",
                                   "params_from_numpy", "launch.serve"])
def test_lm_entry_points_default_to_the_card(entry, monkeypatch):
    """The LM path's entry points run on the card unless the caller names
    the CPU, and raise without a card."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("qwen2.5-3b").reduced())
    meta = pipeline.synth_corpus_meta(100)
    make = {
        "Model.init": lambda **kw: model.init(0, **kw)["embed"],
        "init_cache": lambda **kw: model.init_cache(1, 8, **kw)["self"]["k"],
        "filter_documents": lambda **kw: pipeline.filter_documents(
            meta, 64, 250, 256, **kw),
        "FilteredSyntheticLM": lambda **kw: pipeline.FilteredSyntheticLM(
            pipeline.DataConfig(10, 4, 2), n_docs=100, **kw).mask,
        "params_from_numpy": lambda **kw: convert.params_from_numpy(
            {"a": {"b": np.ones(3, np.float32)}}, **kw)["a"]["b"],
        "launch.serve": lambda **kw: serve.main(
            ["--requests", "1", "--max-new", "1"]
            + (["--device", kw["device"]] if kw else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    out = make(device="cpu")
    if isinstance(out, torch.Tensor):
        assert out.device.type == "cpu"


@pytest.mark.parametrize("entry", ["init_state", "Checkpointer.restore",
                                   "Supervisor", "state_from_numpy",
                                   "launch.train"])
def test_train_entry_points_default_to_the_card(entry, monkeypatch,
                                                tmp_path):
    """The training path's entry points run on the card unless the caller
    names the CPU, and raise without a card."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.runtime import HostFailure, Supervisor
    from repro_torch.train.step import init_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("qwen2.5-3b").reduced())
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, {"w": torch.ones(3)}, blocking=True)

    def supervised(**kw):
        """One injected failure: the supervisor restores step 1."""
        failed = []

        def injector(step):
            if not failed:
                failed.append(step)
                raise HostFailure()

        state, _ = Supervisor(ck, **kw).run(
            {"w": torch.zeros(3)}, lambda s: None,
            lambda st, b: (st, {}), 1, 2, failure_injector=injector)
        return state["w"]

    make = {
        "init_state": lambda **kw: init_state(model, 0, **kw)["opt"]["step"],
        "Checkpointer.restore": lambda **kw: ck.restore(**kw)[1]["w"],
        "Supervisor": supervised,
        "state_from_numpy": lambda **kw: convert.state_from_numpy(
            {"params": {"a": np.ones(3, np.float32)},
             "opt": {"step": np.int32(0)}}, **kw)["opt"]["step"],
        "launch.train": lambda **kw: train.main(
            ["--reduced", "--steps", "1", "--batch", "2", "--seq", "8",
             "--ckpt-dir", str(tmp_path / "launch")]
            + (["--device", kw["device"]] if kw else []))[1]["opt"]["step"],
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["analyse_cell", "build_cell",
                                   "launch.dryrun"])
def test_dryrun_entry_points_default_to_the_card(entry, monkeypatch,
                                                 tmp_path):
    """The dry-run's fake tensors lie on the card unless the caller names
    the CPU, and its entry points raise without a card."""
    import json
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2.5-3b").reduced()
    shape = ShapeConfig("decode_32k", 16, 2, "decode")

    def built(**kw):
        with dryrun.fake_mode():
            return dryrun.build_cell("qwen2.5-3b", "decode_32k", None,
                                     **kw)[1][2]["pos"]

    def launched(**kw):
        dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                     "--out", str(tmp_path)]
                    + (["--device", kw["device"]] if kw else []))
        with open(tmp_path / "mamba2-780m__long_500k__single_pod_16x16"
                  ".json") as fh:
            return json.load(fh)["device"]

    make = {
        "analyse_cell": lambda **kw: dryrun.analyse_cell(
            cfg, shape, None, **kw)["device"],
        "build_cell": built,
        "launch.dryrun": launched,
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    out = make(device="cpu")
    assert (out.device.type if isinstance(out, torch.Tensor) else out) \
        == "cpu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or without CUDA, the script exits non-zero
    and prints no result line."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and '"ok"' not in out.stdout
