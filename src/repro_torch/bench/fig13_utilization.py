"""Paper Fig. 13: fabric utilization (% of PE-cycles doing useful work).

Claim: ~70% higher utilization than SOTA on irregular workloads (the
direct effect of executing AMs on idle PEs en route).

The port of the reference's ``benchmarks/fig13_utilization.py``: a formatter
over :func:`repro_torch.bench.harness.run_all`'s table (run on the
card when no table is given), printing the reference's text and
returning its dict; the "(paper: ...)" figures are the paper's claims.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.harness import run_all
from repro_torch.core.metrics import geomean

IRREGULAR = ["spmspm_s1", "spmspm_s2", "spmspm_s3", "spmspm_s4", "spmv",
             "spmadd", "sddmm", "bfs", "sssp", "pagerank"]


def main(table=None):
    table = table or run_all()
    print("=" * 78)
    print("Fig. 13 — fabric utilization (%)")
    print("=" * 78)
    print(f"{'workload':<14}{'nexus':>8}{'tia':>8}{'tia_val':>9}"
          f"{'cgra':>8}   balance(max/mean busy)")
    gains = []
    for name, e in table.items():
        row = f"{name:<14}"
        for arch in ("nexus", "tia", "tia_valiant", "cgra"):
            if arch in e["archs"]:
                u = 100 * e["archs"][arch]["utilization"]
                row += f"{u:>{9 if arch == 'tia_valiant' else 8}.1f}"
            else:
                row += f"{'n/a':>{9 if arch == 'tia_valiant' else 8}}"
        bal = []
        for arch in ("nexus", "tia"):
            if arch in e["archs"] and "per_pe_busy" in e["archs"][arch]:
                b = np.asarray(e["archs"][arch]["per_pe_busy"], np.float64)
                bal.append(f"{b.max() / max(b.mean(), 1):.2f}")
            else:
                bal.append("n/a")
        print(row + f"   nx {bal[0]} / tia {bal[1]}")
        if (name in IRREGULAR and "nexus" in e["archs"]
                and "tia" in e["archs"]):
            gains.append(e["archs"]["nexus"]["utilization"]
                         / max(e["archs"]["tia"]["utilization"], 1e-9))
    print("-" * 78)
    vs_tia = geomean(gains) if gains else None
    print("geomean utilization gain vs TIA (irregular): "
          + (f"{vs_tia:.2f}x" if vs_tia else "n/a")
          + "   (paper: ~1.7x vs SOTA)")
    return dict(util_vs_tia=vs_tia)


if __name__ == "__main__":
    main()
