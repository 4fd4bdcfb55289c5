"""Distributed data placement (paper §3.1.1, §3.6, Algorithm 1).

Two cooperating strategies, exactly as in the paper:

* **nnz-balanced row partitioning** — rows of a CSR tensor are assigned to the
  N processing elements so that every PE owns ≈ nnz/N nonzeros (not an equal
  number of rows).  Computed by a linear scan of the row-pointer array, O(m).
* **dissimilarity-aware mapping (Algorithm 1)** — rows are described by the
  set of memory banks their column indices touch, L_i; the distance between
  two rows is the symmetric difference |L_i Δ L_j|.  Rows with *similar* bank
  sets are clustered onto the same PE while dissimilar rows are spread apart,
  which de-conflicts concurrent accesses across the fabric.

Both return a ``Placement`` that the compiler (static AMs) and the scale layer
(`repro.sparse.dispatch`) consume.  Secondary (dense) tensors are partitioned
uniformly and co-aligned with the primary tensor (§3.1.1).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Placement",
    "nnz_balanced_rows",
    "bank_signatures",
    "dissimilarity_cluster",
    "partition_csr",
    "uniform_partition",
    "expert_placement",
]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Row → PE assignment plus per-PE row lists.

    Attributes:
      row_to_pe: (m,) int32, PE id owning each row.
      pe_rows:   list of N int32 arrays, rows owned by each PE (in order).
      nnz_per_pe: (N,) int64, load proxy actually assigned.
    """

    row_to_pe: np.ndarray
    pe_rows: list[np.ndarray]
    nnz_per_pe: np.ndarray

    @property
    def n_parts(self) -> int:
        return len(self.pe_rows)

    def imbalance(self) -> float:
        """max/mean load ratio (1.0 = perfectly balanced)."""
        mean = float(self.nnz_per_pe.mean())
        if mean == 0:
            return 1.0
        return float(self.nnz_per_pe.max()) / mean


def _placement_from_assignment(row_to_pe: np.ndarray, nnz: np.ndarray,
                               n_parts: int) -> Placement:
    row_to_pe = np.asarray(row_to_pe, dtype=np.int32)
    pe_rows = [np.where(row_to_pe == k)[0].astype(np.int32)
               for k in range(n_parts)]
    load = np.zeros((n_parts,), dtype=np.int64)
    np.add.at(load, row_to_pe, nnz.astype(np.int64))
    return Placement(row_to_pe, pe_rows, load)


def nnz_balanced_rows(rowptr: np.ndarray, n_parts: int) -> Placement:
    """Contiguous nnz-balanced split: Σ_{r∈R_k} nnz(r) ≈ nnz/N  (§3.1.1).

    Linear scan over ``rowptr`` — rows stay contiguous, so secondary tensors
    co-partition by simple index ranges.
    """
    rowptr = np.asarray(rowptr, dtype=np.int64)
    m = rowptr.shape[0] - 1
    nnz = np.diff(rowptr)
    total = int(rowptr[-1])
    if total == 0:
        # All-zero matrix: every searchsorted boundary collapses to 0 and
        # the last PE would inherit EVERY row.  Fall back to contiguous
        # equal-rows splitting (the only balance signal left).
        row_to_pe = (np.arange(m) * n_parts // max(1, m)).astype(np.int32)
        return _placement_from_assignment(row_to_pe, nnz, n_parts)
    # Target cumulative boundaries at i*total/N; np.searchsorted on the
    # cumulative nnz gives the O(m) linear-scan equivalent.
    cum = rowptr[1:]  # cumulative nnz *after* each row
    bounds = [np.searchsorted(cum, (k + 1) * total / n_parts, side="left")
              for k in range(n_parts - 1)]
    bounds = np.concatenate(
        [[0], np.clip(bounds, 0, m), [m]]).astype(np.int64)
    row_to_pe = np.zeros((m,), dtype=np.int32)
    for k in range(n_parts):
        row_to_pe[bounds[k]:bounds[k + 1]] = k
    return _placement_from_assignment(row_to_pe, nnz, n_parts)


def bank_signatures(rowptr: np.ndarray, col: np.ndarray, n_banks: int,
                    n_cols: int) -> np.ndarray:
    """L_i as a boolean matrix (m, n_banks): banks touched by each row.

    Bank of a column index = col // ceil(n_cols / n_banks) (block-cyclic would
    also work; the paper leaves the hash unspecified).
    """
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    m = rowptr.shape[0] - 1
    bank_of = col // max(1, -(-n_cols // n_banks))
    sig = np.zeros((m, n_banks), dtype=bool)
    row_of = np.repeat(np.arange(m), np.diff(rowptr))
    sig[row_of, np.clip(bank_of, 0, n_banks - 1)] = True
    return sig


def dissimilarity_cluster(
    rowptr: np.ndarray,
    col: np.ndarray,
    n_parts: int,
    *,
    n_banks: int = 16,
    n_cols: int | None = None,
) -> Placement:
    """Algorithm 1: dissimilarity-aware data partitioning.

    Greedy balanced clustering on d(i,j) = |L_i Δ L_j|: rows are grouped so
    that rows with *similar* bank signatures land on the same PE (minimising
    intra-PE contention spread) subject to the nnz-balance constraint.  The
    paper's ``Cluster`` step is unspecified; we use nnz-capacitated greedy
    assignment to the nearest cluster centroid in Hamming space, seeded by a
    max-dissimilarity (k-means++-style) sweep — O(m · N · banks).
    """
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    m = rowptr.shape[0] - 1
    nnz = np.diff(rowptr)
    if n_cols is None:
        n_cols = int(col.max()) + 1 if col.size else 1
    sig = bank_signatures(rowptr, col, n_banks, n_cols).astype(np.float64)

    # --- seed N centroids by max pairwise dissimilarity (farthest-first) ----
    rng = np.random.default_rng(0)
    seeds = [int(rng.integers(m))] if m else []
    for _ in range(1, min(n_parts, m)):
        # distance of every row to its nearest existing seed (Hamming)
        d = np.full((m,), np.inf)
        for s in seeds:
            ds = np.abs(sig - sig[s]).sum(axis=1)  # |L_i Δ L_s|
            d = np.minimum(d, ds)
        seeds.append(int(d.argmax()))
    centroids = sig[seeds] if m else np.zeros((n_parts, n_banks))
    if centroids.shape[0] < n_parts:  # fewer rows than parts
        centroids = np.vstack(
            [centroids, np.zeros((n_parts - centroids.shape[0], n_banks))])

    # --- capacitated greedy assignment, largest rows first ------------------
    cap = max(1.0, float(nnz.sum()) / n_parts) * 1.10  # 10% slack
    load = np.zeros((n_parts,), dtype=np.float64)
    counts = np.zeros((n_parts,), dtype=np.int64)
    row_to_pe = np.zeros((m,), dtype=np.int32)
    order = np.argsort(-nnz, kind="stable")
    for r in order:
        d = np.abs(centroids - sig[r]).sum(axis=1)
        # similar rows together  ->  prefer the *closest* centroid with space
        pref = np.argsort(d, kind="stable")
        dest = -1
        for k in pref:
            if load[k] + nnz[r] <= cap:
                dest = int(k)
                break
        if dest < 0:
            dest = int(load.argmin())
        row_to_pe[r] = dest
        load[dest] += nnz[r]
        # incremental centroid update (running mean of signatures)
        counts[dest] += 1
        centroids[dest] += (sig[r] - centroids[dest]) / counts[dest]
    return _placement_from_assignment(row_to_pe, nnz, n_parts)


def partition_csr(
    rowptr: np.ndarray,
    col: np.ndarray,
    n_parts: int,
    *,
    strategy: str = "dissimilarity",
    n_banks: int = 16,
    n_cols: int | None = None,
) -> Placement:
    """Partition a CSR tensor's rows across ``n_parts`` PEs."""
    if strategy == "nnz":
        return nnz_balanced_rows(rowptr, n_parts)
    if strategy == "dissimilarity":
        return dissimilarity_cluster(rowptr, col, n_parts, n_banks=n_banks,
                                     n_cols=n_cols)
    if strategy == "rows":  # naive equal-rows baseline (for ablations)
        m = rowptr.shape[0] - 1
        row_to_pe = (np.arange(m) * n_parts // max(1, m)).astype(np.int32)
        return _placement_from_assignment(row_to_pe, np.diff(rowptr), n_parts)
    raise ValueError(f"unknown strategy {strategy!r}")


def uniform_partition(n_elems: int, n_parts: int) -> np.ndarray:
    """Element → PE for dense 1-D tensors: equal contiguous segments."""
    return (np.arange(n_elems) * n_parts // max(1, n_elems)).astype(np.int32)


def expert_placement(expert_load: Sequence[float], n_devices: int) -> np.ndarray:
    """Scale-layer use of Alg. 1's balance objective: experts → devices.

    Greedy LPT (longest-processing-time) bin packing of expert loads onto
    devices — the MoE analogue of nnz balancing.  Returns (n_experts,) int32.
    """
    load = np.asarray(expert_load, dtype=np.float64)
    order = np.argsort(-load, kind="stable")
    dev_load = np.zeros((n_devices,), dtype=np.float64)
    out = np.zeros((load.shape[0],), dtype=np.int32)
    for e in order:
        d = int(dev_load.argmin())
        out[e] = d
        dev_load[d] += load[e]
    return out
