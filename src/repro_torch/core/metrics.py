"""Performance / power metrics for the simulated fabrics (paper §5, Table 2).

All absolute power numbers are the paper's own synthesis results (22 nm
FDSOI, compiled SRAMs, 588 MHz):

  * Nexus Machine: 3.865 mW total (Table 2); its §5.2 breakdown says Nexus =
    Generic CGRA + 17% power (8% replicated config memories, 0.5% scanners,
    7% dynamic routers, 6% control minus savings), and TIA = 4.626 mW.
  * Peak throughput at matched ALU counts: 16 ALUs × 588 MHz ≈ 9.4 GOPS
    fabric peak; Table 2's 748 MOPS for Nexus is *achieved* throughput on
    the workload mix.

We reuse those constants to convert simulated cycle counts into MOPS and
MOPS/mW — the simulator supplies cycles and op counts; silicon supplies
frequency and watts.  This mirrors how the paper derives Fig. 12 / Table 2.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FREQ_HZ = 588e6            # paper: synthesized peak frequency

# Total fabric power (mW) per architecture, paper §5.2 + Table 2.
POWER_MW = {
    "nexus": 3.865,
    "tia": 4.626,
    "cgra": 3.865 / 1.17,        # Nexus = CGRA + 17% (§5.2)
    "tia_valiant": 4.626,        # same hardware as TIA, different routing
    "systolic": 3.865 / 1.17 * 0.94,  # CGRA minus dynamic routers (~6%)
}


@dataclasses.dataclass(frozen=True)
class PerfPoint:
    name: str
    workload: str
    cycles: int
    useful_ops: int
    utilization: float

    @property
    def seconds(self) -> float:
        return self.cycles / FREQ_HZ

    @property
    def mops(self) -> float:
        return self.useful_ops / max(1e-12, self.seconds) / 1e6

    @property
    def mops_per_mw(self) -> float:
        return self.mops / POWER_MW[self.name]

    def speedup_over(self, other: "PerfPoint") -> float:
        return other.cycles / max(1, self.cycles)


def summarize(points: list[PerfPoint]) -> str:
    hdr = (f"{'arch':12s} {'workload':10s} {'cycles':>9s} {'MOPS':>9s} "
           f"{'MOPS/mW':>9s} {'util%':>6s}")
    rows = [hdr]
    for p in points:
        rows.append(f"{p.name:12s} {p.workload:10s} {p.cycles:9d} "
                    f"{p.mops:9.1f} {p.mops_per_mw:9.1f} "
                    f"{100 * p.utilization:6.1f}")
    return "\n".join(rows)


def geomean(xs) -> float:
    xs = np.asarray(list(xs), dtype=np.float64)
    xs = xs[xs > 0]
    return float(np.exp(np.log(xs).mean())) if xs.size else 0.0
