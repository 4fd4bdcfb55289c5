"""Paper Fig. 11: normalized performance of Nexus Machine vs baselines,
with the % of computations performed in-network (right axis in the paper).

Claims validated here:
  * sparse workloads: Nexus ≈ 1.9x generic CGRA (paper headline, §1/§5.1)
  * average gain over SOTA data-local baseline (TIA): ≈ 1.35x (§7)
  * dense workloads: parity-ish (systolic best — the paper concedes this)

The port of the reference's ``benchmarks/fig11_performance.py``: a formatter
over :func:`repro_torch.bench.harness.run_all`'s table (run on the
card when no table is given), printing the reference's text and
returning its dict; the "(paper: ...)" figures are the paper's claims.
"""
from __future__ import annotations

from repro_torch.bench.harness import run_all
from repro_torch.core.metrics import geomean

SPARSE = ["spmspm_s1", "spmspm_s2", "spmspm_s3", "spmspm_s4", "spmv",
          "spmadd", "sddmm"]
DENSE = ["matmul", "mv", "conv"]
GRAPH = ["bfs", "sssp", "pagerank"]

# baseline column -> printed width (tia_valiant / systolic are wider)
BASELINES = (("cgra", 9), ("tia", 9), ("tia_valiant", 11), ("systolic", 12))


def main(table=None):
    table = table or run_all()
    print("=" * 78)
    print("Fig. 11 — performance normalized to Nexus Machine "
          "(bars > 1 mean Nexus is faster); right column: in-network %")
    print("=" * 78)
    hdr = (f"{'workload':<14}{'sparsity':<14}{'vs cgra':>9}{'vs tia':>9}"
           f"{'vs tia-val':>11}{'vs systolic':>12}{'in-net %':>10}")
    print(hdr)
    ratios = {base: [] for base, _ in BASELINES}
    sparse_cgra = []
    for name, e in table.items():
        nx = e["archs"]["nexus"]["cycles"]
        cols = {}
        for base, width in BASELINES:
            if base in e["archs"]:
                r = e["archs"][base]["cycles"] / nx
                cols[base] = f"{r:{width}.2f}"
                ratios[base].append(r)
                if base == "cgra" and name in SPARSE:
                    sparse_cgra.append(r)
            else:
                # missing baseline (e.g. no CGRA model for this workload):
                # print n/a, keep it out of the geomeans.
                cols[base] = f"{'n/a':>{width}}"
        innet = 100 * e["archs"]["nexus"]["enroute_frac"]
        print(f"{name:<14}{e['sparsity']:<14}{cols['cgra']}{cols['tia']}"
              f"{cols['tia_valiant']}{cols['systolic']}{innet:>9.0f}%")

    print("-" * 78)
    sparse_vs_cgra = geomean(sparse_cgra) if sparse_cgra else None
    all_vs_tia = geomean(ratios["tia"]) if ratios["tia"] else None
    print("geomean speedup vs generic CGRA (sparse): "
          + (f"{sparse_vs_cgra:.2f}x" if sparse_vs_cgra else "n/a")
          + "   (paper: ~1.9x)")
    print("geomean speedup vs SOTA (TIA), all workloads: "
          + (f"{all_vs_tia:.2f}x" if all_vs_tia else "n/a")
          + "   (paper: 1.35x avg)")
    return dict(sparse_vs_cgra=sparse_vs_cgra, all_vs_tia=all_vs_tia)


if __name__ == "__main__":
    main()
