"""Block-CSR container for the port's block-sparse kernels.

Built on the host in numpy, exactly as the reference's
``repro.sparse.formats.BCSR.from_dense``; the arrays come out as torch
tensors on the requested device.  The block capacity ``bcap`` may exceed
the live count ``n_blocks``: lanes at or past it are padding, which every
consumer ignores.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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

