"""Block-CSR SpMM: C = A_bcsr @ B, f32 output.

Replaces the Pallas TPU kernel ``src/repro/kernels/bcsr_spmm/kernel.py``
(``pallas_call_bcsr``; wrapper ``ops.py::bcsr_spmm``).  On a CUDA tensor
:func:`bcsr_spmm` launches the hand-written kernel ``csrc/bcsr_spmm.cu``
(128 x 64 output tiles of a block-row on the f32 tile core of
``csrc/tile_f32.cuh``, each row's contraction split over the ``S`` ranks of
a thread-block cluster and summed in rank order, plain f32 FMA); on a CPU
tensor it runs :func:`bcsr_spmm_plain`, the same function in plain PyTorch.
The kernel's bound and design are noted in the CUDA source's header.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.sparse.formats import BCSR

_FLOATS = (torch.float32, torch.bfloat16)
#: the kernel's output tile (``BM`` x ``BN`` in ``csrc/bcsr_spmm.cu``)
TILE_M, TILE_N = 128, 64
#: the largest split: the portable thread-block cluster size
MAX_SPLIT = 8
#: CTAs an SM that one launch's grid may fill (the kernel's launch bound)
CTAS_PER_SM = 2


def split_ranks(mb: int, bm: int, kp: int, n_sms: int) -> int:
    """``S``, the cluster ranks that split each output tile's contraction:
    1 when the ``mb`` block-rows' tiles already fill the ``n_sms`` SMs,
    else the largest power of two up to :data:`MAX_SPLIT` that keeps the
    ``tiles * S`` CTAs in one wave of :data:`CTAS_PER_SM` an SM (4 at the
    leg's 64 tiles on 132 SMs; 8 measured slower there, its CTAs outgrow
    one wave).  From shapes alone, never the device's ``indptr``, so a
    captured graph replays the same launch."""
    tiles = mb * -(-bm // TILE_M) * -(-kp // TILE_N)
    split = 1
    if tiles < n_sms:
        while split < MAX_SPLIT and tiles * split * 2 <= CTAS_PER_SM * n_sms:
            split *= 2
    return split


def launch_split(a: BCSR, b: torch.Tensor, *, bk: int = 128) -> int:
    """The split :func:`bcsr_spmm` launches by default for CUDA operands
    ``a`` and ``b``: :func:`split_ranks` of their shapes on ``b``'s card."""
    bm = a.block[0]
    kp = -(-b.shape[1] // bk) * bk
    n_sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    return split_ranks(a.shape[0] // bm, bm, kp, n_sms)


def _live_rows(indptr: torch.Tensor, n_live: int) -> torch.Tensor:
    """Block-row of each of the first ``n_live`` lanes."""
    mb = indptr.shape[0] - 1
    lanes = torch.arange(n_live, device=indptr.device, dtype=indptr.dtype)
    return (torch.searchsorted(indptr, lanes, right=True) - 1).clamp(0,
                                                                      mb - 1)


def bcsr_spmm_plain(a: BCSR, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: each block-row sums, in f32, the products
    of its live blocks (lanes below ``n_blocks`` inside the row's
    ``indptr`` range) with the B block-rows they name.  Rows without live
    blocks are zero."""
    m, _ = a.shape
    bm, bn = a.block
    mb = m // bm
    k = b.shape[1]
    indptr = a.indptr.long()
    n_live = min(int(a.n_blocks), a.indices.shape[0])
    lanes = torch.arange(n_live, device=b.device)
    rows = _live_rows(a.indptr, n_live).long()
    # a lane counts only inside its own row's [indptr[r], indptr[r+1])
    ok = (lanes >= indptr[rows]) & (lanes < indptr[rows + 1])
    bsl = b.reshape(-1, bn, k)[a.indices[:n_live].long()].float()
    part = torch.bmm(a.blocks[:n_live].float(), bsl)         # (n_live,bm,k)
    part = part * ok[:, None, None]
    out = torch.zeros((mb, bm, k), dtype=torch.float32, device=b.device)
    out.index_add_(0, rows, part)
    return out.reshape(m, k)


def _check(a: BCSR, b: torch.Tensor) -> None:
    m, n = a.shape
    bm, bn = a.block
    for name, t in (("indptr", a.indptr), ("indices", a.indices)):
        if t.dtype != torch.int32 or t.device != b.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on "
                             f"{b.device}")
    if a.blocks.dtype not in _FLOATS or b.dtype != a.blocks.dtype:
        raise ValueError("blocks and b must share a dtype, f32 or bf16; got "
                         f"{a.blocks.dtype} and {b.dtype}")
    if a.blocks.device != b.device or not a.blocks.is_contiguous() \
            or not b.is_contiguous():
        raise ValueError("blocks and b must be contiguous on one device")
    if m % bm or n % bn or a.indptr.shape != (m // bm + 1,) \
            or a.blocks.shape[1:] != (bm, bn) \
            or a.blocks.shape[0] != a.indices.shape[0]:
        raise ValueError(f"inconsistent BCSR: shape {a.shape}, block "
                         f"{a.block}, blocks {tuple(a.blocks.shape)}")
    if b.dim() != 2 or b.shape[0] != n:
        raise ValueError(f"b must be ({n}, k); got {tuple(b.shape)}")


def bcsr_spmm(a: BCSR, b: torch.Tensor, *, bk: int = 128,
              split: int | None = None) -> torch.Tensor:
    """C = A @ B with block-CSR A.

    Args:
      a: BCSR on the same device as ``b``; blocks f32 or bf16.
      b: (n, k) dense, the blocks' dtype; k is padded to a multiple of
        ``bk`` (as the reference wrapper does) and the result cut back.
      split: the kernel's ``S`` (1, 2, 4 or 8); default
        :func:`launch_split`.
    Returns:
      (m, k) f32.  A CUDA ``b`` launches the kernel (or raises); a CPU
      ``b`` runs :func:`bcsr_spmm_plain`.
    """
    _check(a, b)
    if b.device.type == "cpu":
        return bcsr_spmm_plain(a, b)
    if b.device.type != "cuda":
        raise ValueError(f"no bcsr_spmm for device {b.device}")
    m, _ = a.shape
    bm, bn = a.block
    k = b.shape[1]
    kp = -(-k // bk) * bk
    if split is None:
        split = launch_split(a, b, bk=bk)
    if kp != k:
        b = torch.nn.functional.pad(b, (0, kp - k))
    out = torch.empty((m, kp), dtype=torch.float32, device=b.device)
    n_live = min(int(a.n_blocks), a.indices.shape[0])
    if out.numel():
        symbol = ("bcsr_spmm_f32" if b.dtype == torch.float32
                  else "bcsr_spmm_bf16")
        fn = _build.bind("bcsr_spmm", symbol, 5, 6)
        err = fn(a.indptr.data_ptr(), a.indices.data_ptr(),
                 a.blocks.data_ptr(), b.data_ptr(), out.data_ptr(),
                 m // bm, bm, bn, kp, n_live, split,
                 torch.cuda.current_stream(b.device).cuda_stream)
        _build.check_launch(symbol, err)
        bcsr_spmm.launches += 1
    return out[:, :k]


bcsr_spmm.launches = 0
