"""Sparse containers: ``CSR`` (the paper's format, §2.2) and ``BCSR`` (the
block format of the port's block-sparse kernels).

Built on the host in numpy, exactly as the reference's
``repro.sparse.formats``' ``from_dense``; the arrays come out as torch
tensors on the requested device.  Both carry a padded nonzero region: the
capacity may exceed the live count (``nnz``, ``n_blocks``), and the
padding lanes (column 0, value 0) are harmless to every op in
:mod:`repro_torch.sparse.ops` and ignored by the kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row, padded to a static nonzero capacity."""

    rowptr: torch.Tensor    # (m+1,) int32
    col: torch.Tensor       # (cap,) int32 (padded with 0)
    val: torch.Tensor       # (cap,) dtype
    nnz: int                # live prefix of col/val
    shape: tuple[int, int]

    @property
    def row_ids(self) -> torch.Tensor:
        """(cap,) row index of every (padded) nonzero; pads map to row 0
        with zero value, so segment sums are unaffected."""
        lanes = torch.arange(self.col.shape[0], dtype=self.rowptr.dtype,
                             device=self.rowptr.device)
        return (torch.searchsorted(self.rowptr, lanes, right=True) - 1
                ).clamp(0, self.shape[0] - 1)

    @classmethod
    def from_dense(cls, a, *, cap: int | None = None,
                   device="cuda") -> "CSR":
        a = np.asarray(a)
        m, n = a.shape
        rows, cols = np.nonzero(a)
        nnz = rows.size
        cap = cap or max(1, nnz)
        if cap < nnz:
            raise ValueError(f"cap {cap} < nnz {nnz}")
        rowptr = np.zeros((m + 1,), np.int32)
        np.add.at(rowptr, rows + 1, 1)
        rowptr = np.cumsum(rowptr).astype(np.int32)
        col = np.zeros((cap,), np.int32)
        val = np.zeros((cap,), a.dtype)
        col[:nnz] = cols
        val[:nnz] = a[rows, cols]
        return cls(torch.as_tensor(rowptr, device=device),
                   torch.as_tensor(col, device=device),
                   torch.as_tensor(val, device=device), int(nnz), (m, n))

    def live(self) -> torch.Tensor:
        """(cap,) bool: the lanes below ``nnz``."""
        return torch.arange(self.col.shape[0], device=self.col.device) \
            < self.nnz

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.val.dtype,
                          device=self.val.device)
        v = torch.where(self.live(), self.val, 0)
        return out.index_put_((self.row_ids.long(), self.col.long()), v,
                              accumulate=True)


def random_csr(gen: torch.Generator, m: int, n: int, density: float, *,
               dtype=torch.float32, cap: int | None = None) -> CSR:
    """Test helper: unstructured sparsity at a target density, drawn from
    ``gen`` on its device (the reference draws from ``jax.random``, whose
    stream torch cannot reproduce)."""
    dev = gen.device
    mask = torch.rand((m, n), generator=gen, device=dev) < density
    vals = torch.randn((m, n), generator=gen, device=dev, dtype=dtype)
    dense = torch.where(mask, vals, 0).cpu().numpy()
    return CSR.from_dense(dense, cap=cap, device=dev)


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Block CSR: (bm, bn) dense blocks."""

    indptr: torch.Tensor    # (mb+1,) int32 — block-rows
    indices: torch.Tensor   # (bcap,) int32 — block-column ids (padded)
    blocks: torch.Tensor    # (bcap, bm, bn) f32 or bf16
    n_blocks: int           # live prefix of indices/blocks
    shape: tuple[int, int]
    block: tuple[int, int]

    @classmethod
    def from_dense(cls, a, block: tuple[int, int] = (8, 128), *,
                   cap: int | None = None, dtype=None,
                   device="cuda") -> "BCSR":
        a = np.asarray(a)
        m, n = a.shape
        bm, bn = block
        if m % bm or n % bn:
            raise ValueError(f"shape {(m, n)} is not a multiple of the "
                             f"block {block}")
        mb, nb = m // bm, n // bn
        t = a.reshape(mb, bm, nb, bn).transpose(0, 2, 1, 3)
        nzmask = np.abs(t).sum(axis=(2, 3)) != 0          # (mb, nb)
        brows, bcols = np.nonzero(nzmask)
        nblk = brows.size
        cap = cap or max(1, nblk)
        if cap < nblk:
            raise ValueError(f"cap {cap} < {nblk} nonzero blocks")
        indptr = np.zeros((mb + 1,), np.int32)
        np.add.at(indptr, brows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        indices = np.zeros((cap,), np.int32)
        blocks = np.zeros((cap, bm, bn), a.dtype)
        indices[:nblk] = bcols
        blocks[:nblk] = t[brows, bcols]
        blk = torch.as_tensor(blocks, device=device)
        if dtype is not None:
            blk = blk.to(dtype)
        return cls(torch.as_tensor(indptr, device=device),
                   torch.as_tensor(indices, device=device), blk,
                   int(nblk), (m, n), tuple(block))

