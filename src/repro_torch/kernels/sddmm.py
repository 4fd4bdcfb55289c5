"""Block-sampled dense-dense matmul (SDDMM) at block granularity:
``out[e] = A[brow[e]*bm : +bm, :] @ B[:, bcol[e]*bn : +bn]``, f32.

Replaces the Pallas TPU kernel ``src/repro/kernels/sddmm/kernel.py``
(``pallas_call_sddmm``; wrapper ``ops.py::sddmm_blocks``).  On CUDA
tensors :func:`sddmm_blocks` launches the hand-written kernel
``csrc/sddmm.cu`` (one CTA per 128 x 64 output tile of a block on the
f32 tile core of ``csrc/tile_f32.cuh``, walking the contraction in order,
plain f32 FMA); on CPU tensors it runs
:func:`sddmm_blocks_plain`, the same function in plain PyTorch.  The
kernel's bound and design are noted in the CUDA source's header.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.bfloat16)


def sddmm_blocks_plain(brow: torch.Tensor, bcol: torch.Tensor,
                       a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                       n_blocks: int | None = None) -> torch.Tensor:
    """The plain PyTorch version: gather each live block's A row-panel and
    B column-panel and multiply them in f32; lanes at or past ``n_blocks``
    are zero."""
    bcap = brow.shape[0]
    live = bcap if n_blocks is None else max(0, min(int(n_blocks), bcap))
    d = a.shape[1]
    out = torch.zeros((bcap, bm, bn), dtype=torch.float32, device=a.device)
    arows = a.reshape(-1, bm, d)[brow[:live].long()].float()
    bcols = b.reshape(d, -1, bn).permute(1, 0, 2)[bcol[:live].long()].float()
    out[:live] = torch.bmm(arows, bcols)
    return out


def _check(brow, bcol, a, b, bm, bn) -> None:
    dev = a.device
    for name, t in (("brow", brow), ("bcol", bcol)):
        if t.dtype != torch.int32 or t.device != dev or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 "
                             f"tensor on {dev}")
    if brow.shape != bcol.shape:
        raise ValueError("brow and bcol must have one shape")
    if a.dtype not in _FLOATS or b.dtype != a.dtype:
        raise ValueError("a and b must share a dtype, f32 or bf16; got "
                         f"{a.dtype} and {b.dtype}")
    if b.device != dev or not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("a and b must be contiguous on one device")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] \
            or a.shape[0] % bm or b.shape[1] % bn:
        raise ValueError(f"want a (m, d), b (d, n) with m % {bm} == 0 and "
                         f"n % {bn} == 0; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")


def sddmm_blocks(brow: torch.Tensor, bcol: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, *, bm: int, bn: int, dk: int = 128,
                 n_blocks: int | None = None) -> torch.Tensor:
    """Sampled dense-dense matmul at block granularity.

    Args:
      brow/bcol: (bcap,) int32 block coordinates; lanes at or past
        ``n_blocks`` (default: all live) are ignored and come out zero.
      a: (m, d), b: (d, n), one dtype (f32 or bf16); d is padded to a
        multiple of ``dk`` (as the reference wrapper does).
    Returns:
      (bcap, bm, bn) f32.  CUDA tensors launch the kernel (or raise); CPU
      tensors run :func:`sddmm_blocks_plain`.
    """
    _check(brow, bcol, a, b, bm, bn)
    if a.device.type == "cpu":
        return sddmm_blocks_plain(brow, bcol, a, b, bm=bm, bn=bn,
                                  n_blocks=n_blocks)
    if a.device.type != "cuda":
        raise ValueError(f"no sddmm_blocks for device {a.device}")
    bcap = brow.shape[0]
    live = bcap if n_blocks is None else max(0, min(int(n_blocks), bcap))
    d = a.shape[1]
    dp = -(-d // dk) * dk
    if dp != d:
        a = torch.nn.functional.pad(a, (0, dp - d))
        b = torch.nn.functional.pad(b, (0, 0, 0, dp - d))
    out = torch.empty((bcap, bm, bn), dtype=torch.float32, device=a.device)
    if out.numel():
        symbol = "sddmm_f32" if a.dtype == torch.float32 else "sddmm_bf16"
        fn = _build.bind("sddmm", symbol, 5, 6)
        err = fn(brow.data_ptr(), bcol.data_ptr(), a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), bcap, live, bm, bn, dp,
                 b.shape[1], torch.cuda.current_stream(a.device).cuda_stream)
        _build.check_launch(symbol, err)
        sddmm_blocks.launches += 1
    return out


sddmm_blocks.launches = 0
