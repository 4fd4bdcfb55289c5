"""Ragged grouped matmul (MoE expert compute):
``out[i] = x[i] @ w[expert_of_tile[i // tile_m]]``, f32.

Replaces the Pallas TPU kernel ``src/repro/kernels/group_matmul/kernel.py``
(``pallas_call_group_matmul``; wrappers ``ops.py::group_matmul`` and
``ops.py::grouped_expert_matmul``).  On CUDA tensors :func:`group_matmul`
launches the hand-written kernel ``csrc/group_matmul.cu`` (one CTA per
64-column panel of one expert tile, walking the contraction in order,
plain f32 FMA); on CPU tensors it runs :func:`group_matmul_plain`, the same
function in plain PyTorch.  The kernel's bound and design are noted in the
CUDA source's header.

Unlike the reference wrapper, nothing pads ``d`` or ``f`` to 128: the
kernel masks its edges, so the reference's ``dk`` / ``fk`` block sizes
have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.bfloat16)


def group_matmul_plain(x: torch.Tensor, expert_of_tile: torch.Tensor,
                       w: torch.Tensor, *, tile_m: int) -> torch.Tensor:
    """The plain PyTorch version, grouped by expert: each expert multiplies
    the rows in its tiles (others masked to zero) in f32.  It never gathers
    a weight matrix per tile, and it has no host sync, so it can be
    captured in a CUDA graph.  Rows of a tile whose expert id is out of
    range are NaN, as the kernel writes them."""
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


def _check(x, expert_of_tile, w, tile_m) -> None:
    if x.dtype not in _FLOATS or w.dtype != x.dtype:
        raise ValueError("x and w must share a dtype, f32 or bf16; got "
                         f"{x.dtype} and {w.dtype}")
    if expert_of_tile.dtype != torch.int32:
        raise ValueError(f"expert_of_tile must be int32, got "
                         f"{expert_of_tile.dtype}")
    if not (x.device == w.device == expert_of_tile.device):
        raise ValueError("x, expert_of_tile and w must be on one device")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (t, d) and w (e, d, f); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if tile_m <= 0 or x.shape[0] % tile_m:
        raise ValueError(f"t = {x.shape[0]} is not a multiple of tile_m = "
                         f"{tile_m}")
    if expert_of_tile.shape != (x.shape[0] // tile_m,):
        raise ValueError(f"expert_of_tile must be ({x.shape[0] // tile_m},)"
                         f", got {tuple(expert_of_tile.shape)}")
    if x.device.type == "cpu" and expert_of_tile.numel() and (
            int(expert_of_tile.min()) < 0
            or int(expert_of_tile.max()) >= w.shape[0]):
        # on the card the ids are not read back (that would stall the
        # stream); the kernel writes NaN for such a tile instead
        raise ValueError(f"expert ids must lie in [0, {w.shape[0]})")


def group_matmul(x: torch.Tensor, expert_of_tile: torch.Tensor,
                 w: torch.Tensor, *, tile_m: int = 128) -> torch.Tensor:
    """out[i] = x[i] @ w[expert_of_tile[i // tile_m]].

    Args:
      x: (t, d) tokens, f32 or bf16, grouped so that each tile of
        ``tile_m`` rows belongs to one expert (t % tile_m == 0).
      expert_of_tile: (t // tile_m,) int32.
      w: (e, d, f), ``x``'s dtype.
    Returns:
      (t, f) f32.  A CUDA ``x`` launches the kernel (or raises); a CPU
      ``x`` runs :func:`group_matmul_plain`.
    """
    _check(x, expert_of_tile, w, tile_m)
    if x.device.type == "cpu":
        return group_matmul_plain(x, expert_of_tile, w, tile_m=tile_m)
    if x.device.type != "cuda":
        raise ValueError(f"no group_matmul for device {x.device}")
    x, w = x.contiguous(), w.contiguous()
    eid = expert_of_tile.contiguous()
    t, d = x.shape
    n_exp, _, f = w.shape
    out = torch.empty((t, f), dtype=torch.float32, device=x.device)
    if out.numel():
        symbol = ("group_matmul_f32" if x.dtype == torch.float32
                  else "group_matmul_bf16")
        fn = _build.bind("group_matmul", symbol, 4, 5)
        err = fn(x.data_ptr(), eid.data_ptr(), w.data_ptr(), out.data_ptr(),
                 t // tile_m, tile_m, d, f, n_exp,
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check_launch(symbol, err)
        group_matmul.launches += 1
    return out


group_matmul.launches = 0


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


def grouped_expert_matmul(xe: torch.Tensor, w: torch.Tensor, *,
                          tile_m: int | None = None) -> torch.Tensor:
    """Bucketized MoE compute: (e, c, d) @ (e, d, f) -> (e, c, f) f32,
    through :func:`group_matmul` on the tiles of :func:`tile_by_expert`.
    """
    e, c, d = xe.shape
    if w.dim() != 3 or w.shape[0] != e:
        raise ValueError(f"w must be ({e}, {d}, f), got {tuple(w.shape)}")
    x, eid, tile_m = tile_by_expert(xe, tile_m)
    out = group_matmul(x, eid, w, tile_m=tile_m)
    return out.reshape(e, -1, w.shape[2])[:, :c]
