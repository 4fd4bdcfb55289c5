"""Paper Table 2: throughput + power efficiency vs SOTA edge CGRAs.

Our simulator supplies achieved ops/cycle on the benchmark mix; silicon
constants (588 MHz, mW from the paper's synthesis) convert to MOPS and
MOPS/mW.  The *absolute* paper numbers include off-chip effects our sim
abstracts, so the claim we validate is the Nexus:TIA ratio structure
(throughput ↑ and perf/W ↑ despite lower raw power).

The port of the reference's ``benchmarks/table2_efficiency.py``: a formatter
over :func:`repro_torch.bench.harness.run_all`'s table (run on the
card when no table is given), printing the reference's text and
returning its dict; the "(paper: ...)" figures are the paper's claims.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.harness import mops, mops_per_mw, run_all
from repro_torch.core.metrics import POWER_MW, geomean

PAPER = {
    "nexus": dict(mops=748, eff=194, power=3.865),
    "tia": dict(mops=490, eff=106, power=4.626),
}


def main(table=None):
    table = table or run_all()
    print("=" * 78)
    print("Table 2 — throughput & power efficiency (simulated mix vs "
          "paper synthesis)")
    print("=" * 78)
    rows = {}
    for arch in ("nexus", "tia", "tia_valiant", "cgra"):
        ms, es = [], []
        for e in table.values():
            if arch in e["archs"]:
                ms.append(mops(e, arch))
                es.append(mops_per_mw(e, arch))
        rows[arch] = (geomean(ms), geomean(es))
    print(f"{'arch':<14}{'power mW':>10}{'geomean MOPS':>14}"
          f"{'MOPS/mW':>10}")
    for arch, (m, e) in rows.items():
        print(f"{arch:<14}{POWER_MW[arch]:>10.2f}{m:>14.0f}{e:>10.1f}")
    print("-" * 78)
    thr = rows["nexus"][0] / rows["tia"][0]
    eff = rows["nexus"][1] / rows["tia"][1]
    print(f"Nexus/TIA throughput ratio: {thr:.2f}x  "
          f"(paper: {PAPER['nexus']['mops']/PAPER['tia']['mops']:.2f}x)")
    print(f"Nexus/TIA efficiency ratio: {eff:.2f}x  "
          f"(paper: {PAPER['nexus']['eff']/PAPER['tia']['eff']:.2f}x)")
    return dict(thr_ratio=thr, eff_ratio=eff)


if __name__ == "__main__":
    main()
