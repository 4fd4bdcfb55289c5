"""Paper Fig. 12: performance-per-watt normalized to baselines.

Power constants come from the paper's own 22 nm synthesis (§5.2, Table 2):
Nexus = 3.865 mW, TIA = 4.626 mW, CGRA = Nexus/1.17, systolic ≈ CGRA·0.94.
Nexus wins perf/W on sparse despite +17% power because cycles drop more.

The port of the reference's ``benchmarks/fig12_perf_watt.py``: a formatter
over :func:`repro_torch.bench.harness.run_all`'s table (run on the
card when no table is given), printing the reference's text and
returning its dict; the "(paper: ...)" figures are the paper's claims.
"""
from __future__ import annotations

from repro_torch.bench.harness import mops_per_mw, run_all
from repro_torch.core.metrics import geomean


def main(table=None):
    table = table or run_all()
    print("=" * 78)
    print("Fig. 12 — perf/W (MOPS/mW), higher is better")
    print("=" * 78)
    print(f"{'workload':<14}{'nexus':>9}{'tia':>9}{'tia_val':>9}"
          f"{'cgra':>9}{'systolic':>10}")
    ratios = []
    for name, e in table.items():
        row = f"{name:<14}"
        for arch in ("nexus", "tia", "tia_valiant", "cgra", "systolic"):
            if arch in e["archs"]:
                v = mops_per_mw(e, arch)
                row += f"{v:>{10 if arch == 'systolic' else 9}.1f}"
            else:
                row += f"{'n/a':>{10 if arch == 'systolic' else 9}}"
        print(row)
        if "nexus" in e["archs"] and "tia" in e["archs"]:
            ratios.append(mops_per_mw(e, "nexus") / mops_per_mw(e, "tia"))
    print("-" * 78)
    vs_tia = geomean(ratios) if ratios else None
    print("geomean perf/W vs TIA: "
          + (f"{vs_tia:.2f}x" if vs_tia else "n/a")
          + "   (paper Table 2 ratio: 194/106 = 1.83x on its mix)")
    return dict(perf_watt_vs_tia=vs_tia)


if __name__ == "__main__":
    main()
