"""The port's ``launch/hloparse.py`` against the reference's: the file is
carried over byte for byte (it imports only ``re``, ``collections`` and
``typing``), ``tests/test_hloparse.py``'s four cases run on both
packages, and both parse a real HLO text - a small jitted function
compiled by the reference's JAX on the CPU - to equal results."""

import filecmp
import os

import jax
import jax.numpy as jnp
import pytest

import repro.launch.hloparse as ref_hlo
import repro_torch.launch.hloparse as port_hlo
import test_hloparse

ROOT = os.path.join(os.path.dirname(__file__), "..", "src")
PACKAGES = {"repro": ref_hlo, "repro_torch": port_hlo}
CASES = ("test_trip_count_and_multipliers", "test_dot_flops_trip_weighted",
         "test_collective_bytes_trip_weighted", "test_shapes_table")


def test_the_port_carries_the_file_byte_for_byte():
    assert filecmp.cmp(os.path.join(ROOT, "repro", "launch", "hloparse.py"),
                       os.path.join(ROOT, "repro_torch", "launch",
                                    "hloparse.py"), shallow=False)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_reference_case_on_both_packages(package, case, monkeypatch):
    monkeypatch.setattr(test_hloparse, "HloModule",
                        PACKAGES[package].HloModule)
    getattr(test_hloparse, case)()


def _compiled_hlo() -> str:
    """A scan of products and a reduction, compiled on the CPU."""
    def f(x, w):
        def body(h, _):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, None, length=5)
        return jnp.sum(h @ w.T)

    x = jnp.ones((16, 32), jnp.float32)
    w = jnp.ones((32, 32), jnp.float32) * 0.01
    return jax.jit(f).lower(x, w).compile().as_text()


def test_both_packages_parse_a_compiled_module_alike():
    hlo = _compiled_hlo()
    got = {}
    for name, mod in PACKAGES.items():
        m = mod.HloModule(hlo)
        got[name] = (dict(m.mult), dict(m.shapes), m.dot_flops(),
                     m.traffic_bytes(), m.collective_bytes(),
                     mod.dot_flops(hlo), mod.traffic_bytes(hlo),
                     mod.collective_bytes(hlo))
    assert got["repro"] == got["repro_torch"]
    assert got["repro_torch"][2] > 0 and got["repro_torch"][3] > 0
