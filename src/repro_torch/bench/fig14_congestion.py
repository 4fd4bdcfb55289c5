"""Paper Fig. 14: network congestion at each router input port, Nexus vs
TIA (dense workloads omitted — fixed dataflow ⇒ minimal congestion, as in
the paper).  Congestion proxy: head-of-line stall cycles per port.

The port of the reference's ``benchmarks/fig14_congestion.py``: a formatter
over :func:`repro_torch.bench.harness.run_all`'s table (run on the
card when no table is given), printing the reference's text and
returning its dict; the "(paper: ...)" figures are the paper's claims.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.harness import run_all

PORTS = ["N", "E", "S", "W", "INJ"]
IRREGULAR = ["spmspm_s1", "spmspm_s2", "spmspm_s3", "spmspm_s4", "spmv",
             "spmadd", "sddmm", "bfs", "sssp", "pagerank"]


def main(table=None):
    table = table or run_all()
    print("=" * 78)
    print("Fig. 14 — congestion (stall cycles) per input port, "
          "Nexus relative to TIA")
    print("=" * 78)
    print(f"{'workload':<14}" + "".join(f"{p:>8}" for p in PORTS)
          + f"{'total nx/tia':>14}")
    ratios = []
    for name in IRREGULAR:
        e = table.get(name)
        if e is None or not {"nexus", "tia"} <= e["archs"].keys():
            continue  # partial table (e.g. smoke grid): skip, don't crash
        nx = np.asarray(e["archs"]["nexus"]["stall_per_port"], np.float64)
        ti = np.asarray(e["archs"]["tia"]["stall_per_port"], np.float64)
        rel = nx / np.maximum(ti, 1)
        tot = nx.sum() / max(ti.sum(), 1)
        ratios.append(tot)
        print(f"{name:<14}" + "".join(f"{r:>8.2f}" for r in rel)
              + f"{tot:>14.2f}")
    print("-" * 78)
    avg = float(np.mean(ratios)) if ratios else None
    print("mean congestion, Nexus / TIA: "
          + (f"{avg:.2f}" if avg is not None else "n/a")
          + " (<1 = Nexus less congested; paper: lower avg congestion)")
    return dict(congestion_vs_tia=avg)


if __name__ == "__main__":
    main()
