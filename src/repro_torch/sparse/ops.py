"""Sparse linear algebra in plain torch ops: the port of the reference's
``repro/sparse/ops.py``, the numerical oracles of the block-sparse kernels.

``spmv``, ``spmm`` (Gustavson), ``spmspm_via_dense``, ``spmadd``, ``sddmm``
and ``bcsr_spmm`` on the padded containers of
:mod:`repro_torch.sparse.formats`.  The reference's ``segment_sum`` is
``index_add_`` here and its ``.at[].add`` is ``index_put_(accumulate=
True)``; on a CUDA device both sum floats in atomic order, so they equal
the reference within a tolerance there, not bit for bit.  Nothing on the
main path calls these, and they call no kernel.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import BCSR, CSR

__all__ = ["spmv", "spmm", "spmadd", "sddmm", "spmspm_via_dense",
           "bcsr_spmm"]


def _segment_sum(data: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = torch.zeros((n, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids.long(), data)


def spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  Gather x[col] (the paper's T2), multiply, segment-add into
    rows (T3): the T1/T2/T3 decomposition of Fig. 4."""
    prod = torch.where(a.live(), a.val * x[a.col.long()], 0)
    return _segment_sum(prod, a.row_ids, a.shape[0])


def spmm(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with dense B: each nonzero A[i,k] scales row B[k,:],
    accumulated into C[i,:] (Gustavson)."""
    rows = torch.where(a.live()[:, None], a.val[:, None] * b[a.col.long()],
                       0)
    return _segment_sum(rows, a.row_ids, a.shape[0])


def spmspm_via_dense(a: CSR, b: CSR) -> torch.Tensor:
    """C = A @ B, both sparse: Gustavson via :func:`spmm` over B's dense
    image."""
    return spmm(a, b.to_dense())


def spmadd(a: CSR, b: CSR) -> torch.Tensor:
    """C = A + B (dense image): a scatter-add of both nonzero sets."""
    out = torch.zeros(a.shape, dtype=a.val.dtype, device=a.val.device)
    for c in (a, b):
        out.index_put_((c.row_ids.long(), c.col.long()),
                       torch.where(c.live(), c.val, 0), accumulate=True)
    return out


def sddmm(a: torch.Tensor, b: torch.Tensor, mask: CSR) -> torch.Tensor:
    """out[e] = <A[i_e, :], B[:, j_e]> for each mask nonzero e, aligned with
    ``mask.col`` (padding lanes 0)."""
    rows = a[mask.row_ids.long()]               # (cap, k)
    cols = b[:, mask.col.long()]                # (k, cap)
    vals = torch.einsum("ek,ke->e", rows, cols)
    return torch.where(mask.live(), vals, 0)


def bcsr_spmm(a: BCSR, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with block-CSR A: each (bm, bn) block multiplies the
    matching (bn, k) slice of B, and the products segment-add into
    block-rows (the reference's oracle of the ``bcsr_spmm`` kernel)."""
    m, n = a.shape
    bm, bn = a.block
    k = b.shape[1]
    mb = m // bm
    cap = a.indices.shape[0]
    lanes = torch.arange(cap, dtype=a.indptr.dtype, device=a.indptr.device)
    brow = (torch.searchsorted(a.indptr, lanes, right=True) - 1
            ).clamp(0, mb - 1)
    live = lanes < a.n_blocks
    bslice = b.reshape(n // bn, bn, k)[a.indices.long()]    # (cap, bn, k)
    part = torch.einsum("cij,cjk->cik",
                        torch.where(live[:, None, None], a.blocks, 0), bslice)
    return _segment_sum(part, brow, mb).reshape(m, k)
