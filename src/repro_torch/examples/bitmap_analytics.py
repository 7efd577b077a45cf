"""Bitmap-index analytics (paper Section 8.1): the weekly-active-users
query on all engine backends, with the DRAM ledger *measured* by the
device model - host (non-resident) engine path vs the resident PIM
runtime - and compared against the old analytic formula.

Run:  PYTHONPATH=src python -m repro_torch.examples.bitmap_analytics \
          [--device cpu]
"""

import argparse

import numpy as np

from ..apps.bitmap_index import BitmapIndex, baseline_cpu_ns
from ..core import BitVector, BulkBitwiseEngine
from ..core.bitvector import resolve_device
from ..core.engine import OpStats
from ..pim import AmbitRuntime


def _ledger(st: OpStats) -> tuple:
    return (st.ns, st.energy_nj, st.aap_count, st.bytes_touched)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    n_users, weeks = 1 << 20, 6
    week_names = [f"week{w}" for w in range(weeks)]

    def populate(idx):
        member_rng = np.random.default_rng(1)
        for w in week_names:
            idx.add(w, member_rng.choice(n_users, n_users // 3,
                                         replace=False))
        idx.add("male", member_rng.choice(n_users, n_users // 2,
                                          replace=False))

    for backend in ("torch", "cuda"):
        idx = BitmapIndex(n_users, BulkBitwiseEngine(backend, device=dev))
        populate(idx)
        uniq, per_week, _ = idx.weekly_active_query(week_names, "male")
        out[backend] = (uniq, per_week)
        print(f"[{backend:8s}] users active all {weeks} weeks: {uniq}; "
              f"male per week: {per_week}")

    # Measured DRAM ledger, host path: every AND round-trips the channel.
    # Run it geometry-faithfully - each bitmap reshaped to (16, 65536) so
    # one logical row = one real 8 KB DRAM row, the same layout the
    # resident path uses (a flat 2^20-bit operand would be modeled as one
    # fictitious 128 KB row and undercount AAPs 16x).
    idx = BitmapIndex(n_users, BulkBitwiseEngine("ambit_sim", device=dev))
    populate(idx)
    uniq, per_week, _ = idx.weekly_active_query(week_names, "male")
    out["ambit_sim"] = (uniq, per_week)
    print(f"[ambit_sim] users active all {weeks} weeks: {uniq}; "
          f"male per week: {per_week}")

    eng = BulkBitwiseEngine("ambit_sim", device=dev)
    host_st = OpStats()
    rows = {nm: BitVector.from_bits(
        idx.bitmaps[nm].bits().reshape(16, 65536), device=dev)
        for nm in week_names + ["male"]}
    acc = rows[week_names[0]]
    for nm in week_names[1:]:
        acc = eng.and_(acc, rows[nm])
        host_st += eng.last_stats
    for nm in week_names:
        eng.and_(rows[nm], rows["male"])
        host_st += eng.last_stats
    assert int(acc.popcount().sum()) == uniq
    out["host_ledger"] = _ledger(host_st)
    print(f"[ambit_sim] measured host-path ledger: {host_st.ns/1e3:.1f} us "
          f"{host_st.energy_nj/1e3:.2f} uJ aap={host_st.aap_count} "
          f"host_bytes={host_st.bytes_touched}")

    # Measured DRAM ledger, resident path: bitmaps live in DRAM, queries
    # lower as whole expression trees, only popcounts read data back.
    rt = AmbitRuntime(seed=2, device=dev)
    idx = BitmapIndex(n_users, runtime=rt)
    populate(idx)
    uniq_r, per_week_r, res_st = idx.weekly_active_query(week_names, "male")
    assert (uniq_r, per_week_r) == (uniq, per_week), "paths disagree"
    out["resident_ledger"] = _ledger(res_st) + (rt.store.bytes_to_device,
                                                rt.host_reads)
    print(f"[resident ] measured ledger: {res_st.ns/1e3:.1f} us "
          f"{res_st.energy_nj/1e3:.2f} uJ aap={res_st.aap_count} "
          f"host_bytes={res_st.bytes_touched} "
          f"(upload once: {rt.store.bytes_to_device} B, "
          f"read-backs: {rt.host_reads})")

    # Sharded resident path: the same bitmaps over a 4-device PimCluster.
    # Round-robin chunk placement + the near= chain keep co-queried
    # bitmaps chunk-aligned, so each device runs 1/4 of every op (time is
    # max-over-devices) and the measured inter-device traffic stays zero.
    rt4 = AmbitRuntime(devices=4, seed=2, device=dev)
    idx = BitmapIndex(n_users, runtime=rt4)
    populate(idx)
    uniq_s, per_week_s, sh_st = idx.weekly_active_query(week_names, "male")
    assert (uniq_s, per_week_s) == (uniq, per_week), "sharded disagrees"
    led = rt4.store.ledger
    out["sharded_ledger"] = _ledger(sh_st) + (led.inter_device_bytes,)
    print(f"[sharded x4] measured ledger: {sh_st.ns/1e3:.1f} us "
          f"{sh_st.energy_nj/1e3:.2f} uJ aap={sh_st.aap_count} "
          f"({res_st.ns/sh_st.ns:.1f}x vs 1 device; inter-device "
          f"{led.inter_device_bytes} B measured)")

    # Accelerator-resident path: the SAME app code on the cuda backend.
    # Bitmaps upload once as device tensors; the whole weekly query
    # drains as fused stacked kernel launches and only popcounts read
    # back - bytes_touched counts just those transfers (vs 3 buffers/op
    # for the non-resident engine path above).
    rt_dev = AmbitRuntime(backend="cuda", device=dev)
    idx = BitmapIndex(n_users, runtime=rt_dev)
    populate(idx)
    uniq_d, per_week_d, dev_st = idx.weekly_active_query(week_names, "male")
    assert (uniq_d, per_week_d) == (uniq, per_week), "device disagrees"
    out["device_ledger"] = (dev_st.bytes_touched, rt_dev.store.bytes_to_device,
                            rt_dev.host_reads, rt_dev.planner.kernel_launches)
    print(f"[cuda res  ] traffic ledger: query host_bytes="
          f"{dev_st.bytes_touched} B (uploads once: "
          f"{rt_dev.store.bytes_to_device} B, read-backs: "
          f"{rt_dev.host_reads}, fused launches: "
          f"{rt_dev.planner.kernel_launches})")

    # Observability: the same ledgers as labeled metric series. Bytes
    # are broken down by WHY they crossed the channel (upload vs
    # fault-in vs spill vs read-back) and per-bank busy ns comes from
    # the planner's bank_busy_ns counter - the series the utilization
    # report and trace exporter consume (see README "Observability").
    snap = rt.metrics_snapshot()
    io = {k: int(v) for k, v in snap["counters"].items()
          if k.startswith("store_io_bytes")}
    busy = {k: v for k, v in snap["counters"].items()
            if k.startswith("bank_busy_ns")}
    print("[metrics  ] bytes by cause:")
    for k in sorted(io):
        print(f"             {k} = {io[k]}")
    total_busy = sum(busy.values())
    out["io_bytes"] = io
    out["busy"] = (len(busy), total_busy)
    print(f"[metrics  ] banks={len(busy)} total_busy_ns={total_busy:.0f}"
          + (f" mean_busy_pct="
             f"{100.0 * total_busy / (len(busy) * res_st.ns):.1f}"
             if busy and res_st.ns else ""))

    # Analytic model (what this example used to print) for comparison.
    n_ops = 2 * weeks - 1
    n_rows = n_users // 65536
    analytic_ns = n_ops * max(1, n_rows // 8) * 4 * 49.0
    cpu_ns = baseline_cpu_ns(n_users, n_ops)
    out["analytic"] = (analytic_ns, cpu_ns)
    print(f"analytic: Ambit {analytic_ns/1e3:.1f} us (vs measured resident "
          f"{res_st.ns/1e3:.1f} us) | CPU {cpu_ns/1e3:.1f} us -> "
          f"{cpu_ns/res_st.ns:.1f}x measured "
          f"(paper reports ~6x end-to-end)")
    return out


if __name__ == "__main__":
    main()
