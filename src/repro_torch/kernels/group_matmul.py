"""Ragged grouped matmul (MoE expert compute):
``out[i] = x[i] @ w[expert_of_tile[i // tile_m]]``, f32, or with
``trans_w`` ``x[i] @ w[e]^T``.

Replaces the Pallas TPU kernel ``src/repro/kernels/group_matmul/kernel.py``
(``pallas_call_group_matmul``; wrappers ``ops.py::group_matmul`` and
``ops.py::grouped_expert_matmul``).  On CUDA tensors :func:`group_matmul`
launches the hand-written kernel ``csrc/group_matmul.cu``, whose launcher
picks the CTA shape from the dtype, ``tile_m``, the widths and the
alignment (:func:`launch_shape` names it):

* tiles of up to 16 rows: a weight stream (the serving calls), which the
  weights' bytes bound;
* bf16 tiles of more than 16 rows whose widths are multiples of 8 (the
  training calls): the tensor-core shape, a TMA ring of 64-deep slices
  feeding ``wgmma`` (bf16 in, f32 accumulated), 64 or 128 rows of one tile
  by 256 columns a CTA.  It reads ``w`` in either layout in place, so a
  transposed product (the backward's dx) needs no copy.  At Phi-3.5-MoE's
  and DeepSeek-V2-Lite's training shapes the weights' bytes bound it too
  (0.276 and 0.121 ms on an H100);
* other wide tiles (f32, or bf16 the TMA cannot take): 128 x 128 tiles of
  the f32 tile core ``csrc/tile_f32.cuh``, plain f32 FMA.  A transposed
  product there runs on a contiguous transposed copy of ``w``, made in
  :func:`_launch_operands`, the one place that chooses it.

On CPU tensors it runs :func:`group_matmul_plain`, the same function in
plain PyTorch.  The kernel's bounds and design are noted in the CUDA
source's header.

Both are the implementations of one operator,
``torch.ops.repro_torch.group_matmul`` (``torch.library.custom_op``), with
a fake implementation (a ``FakeTensorMode`` run gets its (t, n) f32 shape
without a kernel) and a FLOP formula in ``torch.utils.flop_counter``'s
registry that counts the rows the kernel multiplies, ``2 t d f`` in either
layout.  So a dispatch mode, such as the dry run's counter
(``repro_torch.launch.roofline.Counter``), sees one operator where the
kernel runs, whichever device runs it.

Unlike the reference wrapper, nothing pads ``d`` or ``f`` to 128: the
kernel masks its edges, so the reference's ``dk`` / ``fk`` block sizes
have no counterpart here.
"""
from __future__ import annotations

import threading

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.bfloat16)


def group_matmul_plain(x: torch.Tensor, expert_of_tile: torch.Tensor,
                       w: torch.Tensor, *, tile_m: int,
                       trans_w: bool = False) -> torch.Tensor:
    """The plain PyTorch version, grouped by expert: each expert multiplies
    the rows in its tiles (others masked to zero) in f32.  It never gathers
    a weight matrix per tile, and it has no host sync, so it can be
    captured in a CUDA graph.  Rows of a tile whose expert id is out of
    range are NaN, as the kernel writes them.  ``trans_w``: ``w`` is
    (e, f, d) and multiplies as its contiguous transposed copy."""
    if trans_w:
        w = w.transpose(1, 2).contiguous()
    t = x.shape[0]
    n_exp, _, f = w.shape
    row_exp = expert_of_tile.long()[:, None].expand(-1, tile_m).reshape(t)
    xf = x.float()
    out = torch.zeros((t, f), dtype=torch.float32, device=x.device)
    for e in range(n_exp):
        part = xf @ w[e].float()
        out += torch.where((row_exp == e)[:, None], part, 0.0)
    bad = (row_exp < 0) | (row_exp >= n_exp)
    return torch.where(bad[:, None], torch.nan, out)


def _check(x, expert_of_tile, w, tile_m, trans_w=False) -> None:
    """Dtypes, devices and shapes (no value is read: the op's fake tensors
    have none)."""
    if x.dtype not in _FLOATS or w.dtype != x.dtype:
        raise ValueError("x and w must share a dtype, f32 or bf16; got "
                         f"{x.dtype} and {w.dtype}")
    if expert_of_tile.dtype != torch.int32:
        raise ValueError(f"expert_of_tile must be int32, got "
                         f"{expert_of_tile.dtype}")
    if not (x.device == w.device == expert_of_tile.device):
        raise ValueError("x, expert_of_tile and w must be on one device")
    if x.dim() != 2 or w.dim() != 3 or w.shape[2 if trans_w else 1] \
            != x.shape[1]:
        want = "(t, f) and w (e, d, f)" if trans_w else "(t, d) and w " \
            "(e, d, f)"
        raise ValueError(f"x must be {want}; got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if tile_m <= 0 or x.shape[0] % tile_m:
        raise ValueError(f"t = {x.shape[0]} is not a multiple of tile_m = "
                         f"{tile_m}")
    if expert_of_tile.shape != (x.shape[0] // tile_m,):
        raise ValueError(f"expert_of_tile must be ({x.shape[0] // tile_m},)"
                         f", got {tuple(expert_of_tile.shape)}")


@torch.library.custom_op("repro_torch::group_matmul", mutates_args=(),
                         device_types="cpu")
def _group_matmul_op(x: torch.Tensor, expert_of_tile: torch.Tensor,
                     w: torch.Tensor, tile_m: int,
                     trans_w: bool = False) -> torch.Tensor:
    """The operator's CPU implementation: :func:`group_matmul_plain`, after
    the expert ids are read back and checked (on the card they are not
    read: that would stall the stream, and the kernel writes NaN for such
    a tile instead)."""
    if expert_of_tile.numel() and (
            int(expert_of_tile.min()) < 0
            or int(expert_of_tile.max()) >= w.shape[0]):
        raise ValueError(f"expert ids must lie in [0, {w.shape[0]})")
    return group_matmul_plain(x, expert_of_tile, w, tile_m=tile_m,
                              trans_w=trans_w)


#: ``csrc/group_matmul.cu``'s ``Variant`` codes, by name
VARIANTS = ("stream8_scalar", "stream8_vec", "stream16_scalar",
            "stream16_vec", "tiled_scalar", "tiled_vec", "tc64", "tc128")
TENSOR_CORE = ("tc64", "tc128")


def _variant(x: torch.Tensor, w: torch.Tensor, tile_m: int, d: int,
             f: int) -> str:
    """The CTA shape the launcher takes for these contiguous operands
    (``d`` the contraction, ``f`` the output width), asked of the CUDA
    source itself, so that the choice is made in one place."""
    fn = _build.bind("group_matmul", "group_matmul_variant", 2, 4,
                     stream=False)
    return VARIANTS[fn(x.data_ptr(), w.data_ptr(),
                       int(x.dtype == torch.bfloat16), tile_m, d, f)]


def _launch_operands(x, w, tile_m: int, trans_w: bool):
    """The contiguous operands of a CUDA launch, ``d`` (the contraction)
    and ``f`` (the output width): a transposed product reads ``w`` in
    place on the tensor-core shape and a contiguous transposed copy on
    any other, whose kernels take only the stored layout (the one place
    that makes that choice)."""
    x, w = x.contiguous(), w.contiguous()
    d = x.shape[1]
    f = w.shape[1] if trans_w else w.shape[2]
    if trans_w and _variant(x, w, tile_m, d, f) not in TENSOR_CORE:
        w, trans_w = w.transpose(1, 2).contiguous(), False
    return x, w, trans_w, d, f


def launch_shape(x: torch.Tensor, w: torch.Tensor, *, tile_m: int,
                 trans_w: bool = False) -> str:
    """The name of the CTA shape a CUDA launch on these operands runs
    (:data:`VARIANTS`), with ``"+copy"`` where a transposed product runs
    on a contiguous transposed copy of ``w``."""
    x, wl, tw, d, f = _launch_operands(x, w, tile_m, trans_w)
    return _variant(x, wl, tile_m, d, f) + ("+copy" if trans_w and not tw
                                            else "")


@_group_matmul_op.register_kernel("cuda")
def _group_matmul_cuda(x, expert_of_tile, w, tile_m, trans_w=False):
    """The operator's CUDA implementation: the hand-written kernel, on the
    operands of :func:`_launch_operands`."""
    x, w, trans_w, d, f = _launch_operands(x, w, tile_m, trans_w)
    eid = expert_of_tile.contiguous()
    t = x.shape[0]
    out = torch.empty((t, f), dtype=torch.float32, device=x.device)
    if out.numel():
        symbol = ("group_matmul_f32" if x.dtype == torch.float32
                  else "group_matmul_bf16")
        fn = _build.bind("group_matmul", symbol, 4, 6)
        err = fn(x.data_ptr(), eid.data_ptr(), w.data_ptr(), out.data_ptr(),
                 t // tile_m, tile_m, d, f, w.shape[0], int(trans_w),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check_launch(symbol, err)
        with _COUNT_LOCK:      # ranks run as threads launch it at once
            group_matmul.launches += 1
    return out


@_group_matmul_op.register_fake
def _group_matmul_fake(x, expert_of_tile, w, tile_m, trans_w=False):
    return x.new_empty((x.shape[0], w.shape[1] if trans_w else w.shape[2]),
                       dtype=torch.float32)


def _group_matmul_flops(x_shape, eid_shape, w_shape, tile_m, *args,
                       **kwargs) -> int:
    """``2 t d f``: every row the kernel multiplies, the tiles' padding
    rows included (the plain version's product of every row by every
    expert is not what the operator does, so it is never counted); ``x``
    is (t, d) or, transposed, (t, f), so it is the same in either layout."""
    return 2 * x_shape[0] * w_shape[1] * w_shape[2]


register_flop_formula(torch.ops.repro_torch.group_matmul)(_group_matmul_flops)


def group_matmul(x: torch.Tensor, expert_of_tile: torch.Tensor,
                 w: torch.Tensor, *, tile_m: int = 128,
                 trans_w: bool = False) -> torch.Tensor:
    """out[i] = x[i] @ w[expert_of_tile[i // tile_m]] (or, ``trans_w``,
    x[i] @ w[e]^T), through the operator
    ``torch.ops.repro_torch.group_matmul``.

    Args:
      x: (t, d) tokens (``trans_w``: (t, f)), f32 or bf16, grouped so that
        each tile of ``tile_m`` rows belongs to one expert
        (t % tile_m == 0).
      expert_of_tile: (t // tile_m,) int32.
      w: (e, d, f), ``x``'s dtype.
      trans_w: multiply by each ``w[e]`` transposed, read in place.
    Returns:
      (t, f) f32 (``trans_w``: (t, d)).  A CUDA ``x`` launches the kernel
      (or raises); a CPU ``x`` runs :func:`group_matmul_plain`; a fake
      ``x`` gives a fake result (``FakeTensorMode``, the dry run), and any
      other device raises.
    """
    _check(x, expert_of_tile, w, tile_m, trans_w)
    if x.device.type not in ("cpu", "cuda"):
        # a fake tensor reports the device it stands in for
        raise ValueError(f"no group_matmul for device {x.device}")
    return torch.ops.repro_torch.group_matmul(x, expert_of_tile, w, tile_m,
                                              trans_w)


group_matmul.launches = 0
_COUNT_LOCK = threading.Lock()


def tile_by_expert(xe: torch.Tensor, tile_m: int | None = None):
    """(e, c, d) -> (x, expert_of_tile, tile_m): the (e, c) plane flattened
    into expert-aligned tiles, each expert's capacity ``c`` padded up to a
    multiple of ``tile_m`` (default ``min(128, max(8, c))``, as the
    reference)."""
    e, c, d = xe.shape
    if tile_m is None:
        tile_m = min(128, max(8, c))
    cp = -(-c // tile_m) * tile_m
    if cp != c:
        xe = torch.nn.functional.pad(xe, (0, 0, 0, cp - c))
    eid = torch.arange(e * cp // tile_m, dtype=torch.int32,
                       device=xe.device) // (cp // tile_m)
    return xe.reshape(e * cp, d), eid, tile_m


def expert_product(xe: torch.Tensor, w: torch.Tensor, tile_m=None, *,
                   trans_w: bool = False) -> torch.Tensor:
    """(e, c, d) @ (e, d, f) -> (e, c, f) f32 (``trans_w``: (e, c, f) @
    (e, d, f)^T -> (e, c, d)) through :func:`group_matmul` on the tiles of
    :func:`tile_by_expert`; not differentiable (the forward and the dx of
    :class:`GroupedExpertMatmul` are each one call)."""
    e, c, d = xe.shape
    if w.dim() != 3 or w.shape[0] != e:
        raise ValueError(f"w must be ({e}, ., .), got {tuple(w.shape)}")
    x, eid, tile_m = tile_by_expert(xe, tile_m)
    out = group_matmul(x, eid, w, tile_m=tile_m, trans_w=trans_w)
    return out.reshape(e, -1, w.shape[1 if trans_w else 2])[:, :c]


class GroupedExpertMatmul(torch.autograd.Function):
    """:func:`grouped_expert_matmul` with its gradient.  The reference
    differentiates its ``ecd,edf->ecf`` einsum with XLA's transposes, in
    the parameters' dtype; so here, with the cotangent ``dy`` cast to
    ``w``'s dtype:

    * ``dxe[e] = dy[e] @ w[e]^T`` is the same grouped product with
      ``trans_w``: one launch of the same kernel.  On the tensor-core
      shape (the bf16 training calls) it reads ``w`` in place, K-major,
      bound by the weights' bytes as the forward is; on any other shape
      the operator multiplies a contiguous (e, f, d) copy (on a CPU
      tensor, the plain version, as the forward);
    * ``dw[e] = xe[e]^T @ dy[e]`` is ``torch.bmm``: the reference computes
      it outside any Pallas kernel.
    """

    @staticmethod
    def forward(ctx, xe, w, tile_m):
        ctx.save_for_backward(xe, w)
        ctx.tile_m = tile_m
        return expert_product(xe, w, tile_m)

    @staticmethod
    def backward(ctx, dy):
        xe, w = ctx.saved_tensors
        dy = dy.to(w.dtype)
        dxe = dw = None
        if ctx.needs_input_grad[0]:
            dxe = expert_product(dy, w, ctx.tile_m, trans_w=True).to(
                xe.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(xe.transpose(1, 2), dy)
        return dxe, dw, None


def grouped_expert_matmul(xe: torch.Tensor, w: torch.Tensor, *,
                          tile_m: int | None = None) -> torch.Tensor:
    """Bucketized MoE compute: (e, c, d) @ (e, d, f) -> (e, c, f) f32,
    through :func:`group_matmul` on the tiles of :func:`tile_by_expert`;
    differentiable (:class:`GroupedExpertMatmul`).
    """
    return GroupedExpertMatmul.apply(xe, w, tile_m)
