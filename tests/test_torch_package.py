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
            "repro_torch.pim.allocator; "
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
