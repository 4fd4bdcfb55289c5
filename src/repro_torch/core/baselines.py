"""Baseline architecture models (paper §4.1).

Four baselines, matched for peak ALU throughput with Nexus Machine:

* **Generic CGRA** (HyCube-like): spatially mapped dataflow with global
  edge memory banks.  All PEs advance in lock-step, so *any* bank conflict
  stalls the whole fabric (§2.2, Fig. 3a).  We replay the workload's actual
  memory-address trace in unrolled waves and charge ``max_bank_requests``
  cycles per wave — the same accounting Morpher's bank-conflict model uses.
* **Systolic array** (TPU-style, weight-stationary 4×4): dense peak
  throughput; sparse operands are processed densely (zeros included); Conv
  pays the im2col data-duplication cost (§5.1); MV uses one column of the
  array.
* **TIA** / **TIA-Valiant**: run on the *same* cycle-level simulator as
  Nexus Machine (``repro_torch.core.machine``) with ``opportunistic=False`` (and
  ``valiant=True``), so the ablation isolates exactly the in-network
  execution mechanism — mirroring the paper's ablation points.

Power constants for perf/W (paper Table 2 + §5.2 overhead analysis) live in
:mod:`repro_torch.core.metrics`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import compiler as nxc
from repro_torch.core.machine import MachineConfig

__all__ = [
    "CgraResult", "cgra_waves_from_trace", "simulate_cgra",
    "cgra_spmv", "cgra_spmspm", "cgra_spmadd", "cgra_sddmm",
    "systolic_matmul_cycles", "systolic_cycles",
]


@dataclasses.dataclass
class CgraResult:
    cycles: int
    ideal_cycles: int
    stall_cycles: int
    utilization: float
    bank_conflict_histogram: np.ndarray   # (n_banks,) total conflicts


def simulate_cgra(mem_waves: list[np.ndarray], *, n_banks: int = 8,
                  n_pes: int = 16, ops_per_wave: int | None = None
                  ) -> CgraResult:
    """Lock-step wave execution with bank-conflict stalls.

    Args:
      mem_waves: one int array of *global addresses* per issue wave — the
        memory requests that must all complete before the fabric advances.
      ops_per_wave: ALU+mem ops kept busy in a non-stalled wave (defaults to
        the number of requests, capped at n_pes).
    """
    cycles = 0
    busy = 0
    hist = np.zeros((n_banks,), dtype=np.int64)
    for wave in mem_waves:
        if wave.size == 0:
            cycles += 1
            continue
        banks = wave % n_banks
        counts = np.bincount(banks, minlength=n_banks)
        serial = int(counts.max())           # a bank serves 1 req/cycle
        hist += np.maximum(counts - 1, 0)
        cycles += max(1, serial)
        ops = ops_per_wave if ops_per_wave is not None else min(
            wave.size, n_pes)
        busy += ops                           # useful work in the wave
    ideal = len(mem_waves)
    util = busy / max(1, cycles * n_pes)
    return CgraResult(cycles=cycles, ideal_cycles=ideal,
                      stall_cycles=cycles - ideal, utilization=util,
                      bank_conflict_histogram=hist)


def cgra_waves_from_trace(addr_lists: list[list[int]], unroll: int
                          ) -> list[np.ndarray]:
    """Group a per-iteration address trace into waves of ``unroll`` iters."""
    waves = []
    for w0 in range(0, len(addr_lists), unroll):
        group = addr_lists[w0:w0 + unroll]
        waves.append(np.array([a for it in group for a in it],
                              dtype=np.int64))
    return waves


def _spmv_trace(a_dense: np.ndarray, x_base: int, y_base: int
                ) -> list[list[int]]:
    """Per-nonzero addresses: stream A element, gather x[col], update y[row].

    A-element streams are sequential (no conflicts); the irregular accesses
    are x[col[e]] (gather) and y[row[e]] (accumulate) — they hit the shared
    banks (Fig. 3a bottom).
    """
    rowptr, col, _ = nxc.csr_from_dense(a_dense)
    m = a_dense.shape[0]
    trace = []
    for i in range(m):
        for e in range(int(rowptr[i]), int(rowptr[i + 1])):
            trace.append([x_base + int(col[e]), y_base + i])
    return trace


def cgra_spmv(a_dense: np.ndarray, *, n_banks: int = 8, n_pes: int = 16,
              unroll: int = 4) -> CgraResult:
    n = a_dense.shape[1]
    trace = _spmv_trace(a_dense, x_base=0, y_base=n)
    # SpMV DFG ≈ 4 nodes (ld-col/ld-val stream, ld-x, mul, acc): unroll 4
    # iterations over 16 PEs.
    return simulate_cgra(cgra_waves_from_trace(trace, unroll),
                         n_banks=n_banks, n_pes=n_pes,
                         ops_per_wave=unroll * 4)


def cgra_spmspm(a_dense: np.ndarray, b_dense: np.ndarray, *,
                n_banks: int = 8, n_pes: int = 16, unroll: int = 4
                ) -> CgraResult:
    """Gustavson on a CGRA: per product A[i,k]*B[k,j]: gather B row element,
    scatter-accumulate C[i,j] into the shared banks."""
    a_rp, a_col, _ = nxc.csr_from_dense(a_dense)
    b_rp, b_col, _ = nxc.csr_from_dense(b_dense)
    m, k = a_dense.shape
    n = b_dense.shape[1]
    b_base, c_base = 0, k * n
    trace = []
    for i in range(m):
        for e in range(int(a_rp[i]), int(a_rp[i + 1])):
            kk = int(a_col[e])
            for f in range(int(b_rp[kk]), int(b_rp[kk + 1])):
                j = int(b_col[f])
                trace.append([b_base + kk * n + j, c_base + i * n + j])
    return simulate_cgra(cgra_waves_from_trace(trace, unroll),
                         n_banks=n_banks, n_pes=n_pes,
                         ops_per_wave=unroll * 4)


def cgra_spmadd(a_dense: np.ndarray, b_dense: np.ndarray, *,
                n_banks: int = 8, n_pes: int = 16, unroll: int = 5
                ) -> CgraResult:
    m, n = a_dense.shape
    trace = []
    for mat, base in ((a_dense, 0), (b_dense, 0)):  # C aliases same banks
        rp, cl, _ = nxc.csr_from_dense(mat)
        for i in range(m):
            for e in range(int(rp[i]), int(rp[i + 1])):
                trace.append([base + i * n + int(cl[e])])
    return simulate_cgra(cgra_waves_from_trace(trace, unroll),
                         n_banks=n_banks, n_pes=n_pes,
                         ops_per_wave=unroll * 3)


def cgra_sddmm(a: np.ndarray, b: np.ndarray, mask: np.ndarray, *,
               n_banks: int = 8, n_pes: int = 16, unroll: int = 2
               ) -> CgraResult:
    m, k = a.shape
    n = b.shape[1]
    rp, cl, _ = nxc.csr_from_dense(mask.astype(np.int64))
    trace = []
    for i in range(m):
        for e in range(int(rp[i]), int(rp[i + 1])):
            j = int(cl[e])
            for kk in range(k):
                # A row stream is sequential; B column gather is strided and
                # conflict-prone on low-order interleaved banks.
                trace.append([m * k + kk * n + j])
    return simulate_cgra(cgra_waves_from_trace(trace, unroll),
                         n_banks=n_banks, n_pes=n_pes,
                         ops_per_wave=unroll * 4)


# ----------------------------------------------------------------------------
# Systolic array (TPU-like, weight stationary), matched ALU count (§4.1).
# ----------------------------------------------------------------------------
def systolic_matmul_cycles(m: int, k: int, n: int, *, dim: int = 4) -> int:
    """(m,k) @ (k,n) on a dim×dim weight-stationary array.

    Weights are loaded tile-by-tile (dim cycles each, overlapped), rows of A
    stream through; one k-deep accumulation per (dim×dim) weight tile.
    """
    tiles = -(-k // dim) * -(-n // dim)
    fill = 2 * dim                       # pipeline fill + drain per tile
    return tiles * (m + fill)


def systolic_cycles(workload: str, shapes: dict, *, dim: int = 4) -> float:
    """Cycle model per workload; sparse operands are processed densely."""
    if workload in ("matmul", "spmspm", "spmadd"):
        m, k, n = shapes["m"], shapes["k"], shapes["n"]
        if workload == "spmadd":
            # element-wise add: streams both operands through the array edge
            # (dim lanes), no MACs reused.
            return m * n / dim
        return float(systolic_matmul_cycles(m, k, n, dim=dim))
    if workload in ("mv", "spmv"):
        m, k = shapes["m"], shapes["k"]
        # one column of the array is useful for a single output vector
        return float(systolic_matmul_cycles(m, k, 1, dim=dim))
    if workload == "sddmm":
        # must compute the full dense product, then sample.
        m, k, n = shapes["m"], shapes["k"], shapes["n"]
        return float(systolic_matmul_cycles(m, k, n, dim=dim))
    if workload == "conv":
        # im2col: data duplication costs extra streaming passes (§5.1);
        # the paper notes systolic "cannot execute Conv natively".
        m, k, n = shapes["m"], shapes["k"], shapes["n"]
        im2col_cost = m * k / dim        # patch materialization, dim words/cyc
        return float(systolic_matmul_cycles(m, k, n, dim=dim)) + im2col_cost
    raise ValueError(f"no systolic mapping for {workload}")
