"""Quickstart: the Ambit bulk bitwise execution engine in 60 lines.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..core import BitVector, BulkBitwiseEngine, Expr, compile_expr, maj
from ..core.bitvector import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n = 100_000

    # 1) BitVectors + the engine (torch backend = portable reference)
    a, b, c = (BitVector.from_bits(rng.integers(0, 2, n).astype(bool),
                                   device=dev) for _ in range(3))
    eng = BulkBitwiseEngine("torch", device=dev)
    result = eng.eval((Expr.var("a") & Expr.var("b")) | ~Expr.var("c"),
                      {"a": a, "b": b, "c": c})
    count = int(eng.popcount(result))
    print(f"(a&b)|~c popcount: {count} / {n}")

    # 2) The same op on the bit-accurate DRAM device model, with the
    #    paper's timing/energy ledger (Section 7 units)
    sim = BulkBitwiseEngine("ambit_sim", device=dev)
    small = {k: BitVector.from_bits(rng.integers(0, 2, 2048).astype(bool),
                                    device=dev)
             for k in "abc"}
    sim.eval(maj(Expr.var("a"), Expr.var("b"), Expr.var("c")), small)
    st = sim.last_stats
    print(f"MAJ on DRAM model: {st.aap_count} AAPs, {st.ns:.0f} ns, "
          f"{st.energy_nj:.1f} nJ")

    # 3) Compile a bitwise expression to an AAP command program (Fig. 20)
    x, y = Expr.var("x"), Expr.var("y")
    comp = compile_expr(~(x & y), {"x": 0, "y": 1}, dst_row=2)
    print(f"nand program ({comp.n_aap} AAPs, {comp.stats.ns:.0f} ns):")
    for m in comp.program:
        print(f"   {m!r}")

    # 4) The hand-written kernel backend (one fused_bitwise launch on
    #    the card; its plain version on the CPU)
    kern = BulkBitwiseEngine("cuda", device=dev)
    r2 = kern.xor(a, b)
    ref = eng.xor(a, b)
    assert torch.equal(r2.bits(), ref.bits())
    print("cuda backend == torch backend: OK")
    return {"popcount": count, "maj_aap": st.aap_count, "maj_ns": st.ns,
            "maj_nj": st.energy_nj, "nand_aap": comp.n_aap,
            "nand_ns": comp.stats.ns, "program": [repr(m) for m in comp.program]}


if __name__ == "__main__":
    main()
