"""The paper's technique at pod scale: AM dispatch over an 8-shard mesh;
the port of the reference's ``examples/sparse_dispatch.py``.

Shards a skewed (power-law rows) matrix over 8 shards two ways, naive
equal rows against the paper's nnz-balanced partitioning (Alg. 1), and
runs :func:`repro_torch.sparse.dispatch.spmv_sharded`, whose inner loop is
the Active-Message flow: messages (value, column offset) travel by an
all-to-all to the shard that owns the x element (T2, data-local), and the
products return to the row owner (T3).  The result is held to the dense
``a @ x`` within 1e-3.

The 8 shards are 8 logical shards of one device (``--devices cuda``, the
default) or a comma-separated list of devices, repeated up to 8:

    python -m repro_torch.launch.sparse_dispatch
    python -m repro_torch.launch.sparse_dispatch --devices cpu
    python -m repro_torch.launch.sparse_dispatch --n 8192
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.partition import nnz_balanced_rows, uniform_partition
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sparse.dispatch import shard_csr_rows, spmv_sharded

N_SHARDS = 8
TOL = 1e-3


def powerlaw_sparse(m: int, n: int, rng, alpha: float = 1.5) -> np.ndarray:
    """A dense (m, n) f32 matrix whose rows hold a Pareto-distributed
    number of normal values (the reference example's generator)."""
    a = np.zeros((m, n), dtype=np.float32)
    for i in range(m):
        k = min(n, max(1, int((rng.pareto(alpha) + 1) * 4)))
        cols = rng.choice(n, size=min(k, n), replace=False)
        a[i, cols] = rng.standard_normal(len(cols))
    return a


def shard_loads(a: np.ndarray, n_shards: int) -> dict:
    """Per-shard nonzeros under equal rows and under nnz-balanced rows."""
    m = a.shape[0]
    rowptr = np.zeros((m + 1,), np.int64)
    rows, _ = np.nonzero(a)
    np.add.at(rowptr, rows + 1, 1)
    rowptr = np.cumsum(rowptr)
    per_row = rowptr[1:] - rowptr[:-1]
    places = {"equal-rows": uniform_partition(m, n_shards),
              "nnz-balanced": nnz_balanced_rows(rowptr, n_shards).row_to_pe}
    return {label: np.array([per_row[place == s].sum()
                             for s in range(n_shards)])
            for label, place in places.items()}


def run(n: int = 512, devices=("cuda",), seed: int = 3,
        verbose: bool = True) -> dict:
    """Build the matrix, shard it over :data:`N_SHARDS` shards of
    ``devices`` (repeated up to 8) and run the sharded SpMV.  Returns the
    loads, the result and its max |err| against the dense product."""
    devs = [devices[i % len(devices)] for i in range(N_SHARDS)]
    mesh = make_host_mesh(N_SHARDS, 1, devices=devs)
    rng = np.random.default_rng(seed)
    a = powerlaw_sparse(n, n, rng)
    x = rng.standard_normal(n).astype(np.float32)
    loads = shard_loads(a, N_SHARDS)
    if verbose:
        print(f"distributed SpMV: {n}x{n}, nnz={np.count_nonzero(a)}, "
              f"{N_SHARDS} shards on {sorted({str(d) for d in devs})}\n")
        for label, ld in loads.items():
            print(f"  {label:<14} per-shard nnz: min={ld.min():>5} "
                  f"max={ld.max():>5} "
                  f"imbalance={ld.max() / ld.mean():.2f}x")
    shards = shard_csr_rows(a, N_SHARDS)
    y = spmv_sharded(mesh, shards, x, axis="data")
    err = float(np.abs(y - a.astype(np.float64) @ x).max())
    if verbose:
        print(f"\nAM-dispatch SpMV max |err| vs dense reference: {err:.2e}")
    if not err < TOL:
        raise AssertionError(f"max |err| {err} over {TOL}")
    if verbose:
        print("OK — the message (instruction+operands) moved to the data, "
              "never the data to the instruction.")
    return dict(loads=loads, y=y, max_abs_err=err,
                nnz=int(np.count_nonzero(a)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--devices", default="cuda",
                    help="comma-separated devices of the 8 shards, repeated "
                         "up to 8 (default: cuda, 8 logical shards of one "
                         "card)")
    ap.add_argument("--n", type=int, default=512,
                    help="rows and columns of the matrix (a multiple of 8)")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    run(args.n, tuple(args.devices.split(",")), args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
