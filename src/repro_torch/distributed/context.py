"""Mesh context for in-model sharding constraints.

The port of the reference's ``repro/distributed/context.py``.
``lm.forward`` and ``moe.moe_apply`` apply their sharding constraints only
when a mesh is installed here (:func:`use_mesh`): without one, and on a
plain tensor, :func:`constrain` is the identity.  The mesh is a named
``torch.distributed.device_mesh.DeviceMesh`` whose ranks the caller has
started; under it the model's tensors are ``DTensor``s, and a constraint
redistributes one (:meth:`DTensor.redistribute`).

The installed mesh is per thread: the reference's one controller holds
one mesh, and here each rank installs its own, which keeps ranks run as
threads of one process apart.
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading

from repro_torch.distributed.sharding import (P, axis_sizes, local_box,
                                              placements)

_LOCAL = threading.local()


def get_mesh():
    return getattr(_LOCAL, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a named ``DeviceMesh``, or None) for this thread.
    Inside it, plain tensors that meet ``DTensor``s (masks, positions and
    other constants the model builds) count as replicated."""
    prev = get_mesh()
    _LOCAL.mesh = mesh
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
    finally:
        _LOCAL.mesh = prev


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the model runs on the mesh).  None
    can exist before ``torch.distributed.tensor`` is imported, so the
    plain path never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def whole(x):
    """A ``DTensor`` gathered to a plain tensor (the same on every rank;
    a collective, so every rank calls it); any other tensor as it is."""
    return x.full_tensor() if is_sharded(x) else x


def fit_axes(axes, shape, mesh) -> P:
    """The constraint's rule: each dim keeps the mesh axes of ``axes`` (one
    entry per dim: None, a name or a tuple of names) that the mesh has, if
    their product divides the dim and is at most the dim; else none."""
    sizes = axis_sizes(mesh)
    fixed = []
    for ax, dim in zip(axes, shape):
        if ax is None:
            fixed.append(None)
            continue
        names = tuple(n for n in (ax if isinstance(ax, tuple) else (ax,))
                      if n in sizes)
        if not names:
            fixed.append(None)
            continue
        size = math.prod(sizes[n] for n in names)
        fixed.append(names if dim % size == 0 and dim >= size else None)
    return P(*fixed)


def fitted_placements(shape, *axes) -> tuple:
    """The DTensor placements on the active mesh of a tensor of ``shape``
    constrained to ``axes`` (:func:`fit_axes`)."""
    mesh = get_mesh()
    return placements(fit_axes(axes, shape, mesh), mesh)


def constrain(x, *axes):
    """Redistribute ``x`` to ``axes`` (one mesh-axis name, tuple of names
    or None per dim of ``x``) if a mesh is active and ``x`` is a
    ``DTensor``; axes that do not fit the dim are dropped
    (:func:`fit_axes`).  Otherwise ``x`` itself."""
    mesh = get_mesh()
    if mesh is None or not is_sharded(x):
        return x
    place = fitted_placements(x.shape, *axes)
    if tuple(x.placements) == place:
        return x
    return x.redistribute(mesh, place)


def batch_only(x):
    """``x`` with its leading (batch) dim split over the batch axes and
    every other dim whole, if a mesh is active and ``x`` is a
    ``DTensor``; otherwise ``x`` itself."""
    if get_mesh() is None or not is_sharded(x):
        return x
    return constrain(x, batch_axes(), *(None,) * (x.dim() - 1))


def batch_axes():
    mesh = get_mesh()
    if mesh is None:
        return None
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def write_slice(dst, src, dim: int, at: int) -> None:
    """``dst[at : at + n]`` along ``dim`` = ``src`` (``n`` its size there),
    in place: XLA's ``dynamic_update_slice`` with the offset already
    clamped.  On a ``DTensor`` each rank writes the part of the range
    that its own shard of ``dim`` holds, from ``src`` gathered along
    ``dim`` (a slice of a sharded dim has no in-place DTensor rule)."""
    n = src.shape[dim]
    if not is_sharded(dst):
        dst.narrow(dim, at, n).copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if p == Shard(dim) else p
                 for p in dst.placements)
    src = src.to(dst.dtype).redistribute(dst.device_mesh, want).to_local()
    local = dst.to_local()
    offsets, sizes = local_box(dst.shape, dst.device_mesh, dst.placements)
    offset, size = offsets[dim], sizes[dim]
    lo = max(at, offset)
    hi = min(at + n, offset + size)
    if hi > lo:
        local.narrow(dim, lo - offset, hi - lo).copy_(
            src.narrow(dim, lo - at, hi - lo))


def gather_data(tree):
    """A layer's parameters with the FSDP axis gathered: every
    ``DTensor`` leaf sharded over ``data`` (or ``pod``) becomes replicated
    there, its ``model`` split kept (the reference's per-layer all-gather
    of the ZeRO axis).  Plain leaves, and everything without a mesh, are
    returned as they are; the result is a nested dict (without a mesh,
    the tree itself)."""
    if get_mesh() is None:
        return tree
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: gather_data(v) for k, v in tree.items()}
    if not is_sharded(tree):
        return tree
    from torch.distributed.tensor import Replicate
    names = tree.device_mesh.mesh_dim_names
    place = tuple(Replicate() if n in ("data", "pod") else p
                  for n, p in zip(names, tree.placements))
    if place == tuple(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, place)


def heads_axis(n: int):
    """``"model"`` if ``n`` heads split evenly over the active mesh's
    ``model`` axis, else None (the heads then stay whole on each rank)."""
    mesh = get_mesh()
    if mesh is None:
        return None
    size = axis_sizes(mesh).get("model", 1)
    return "model" if n % size == 0 else None


def grad_as_input(x):
    """``x`` itself, on a mesh through an explicit redistribution to its
    own placements, whose backward hands the gradient back at ``x``'s
    placements.  Before a reshape that splits a dim ``x`` holds whole
    (heads that do not divide over ``model``): the gradient a
    row-parallel product returns is split along the flat dim, where the
    split cuts inside a head and the reshape's backward has no rule."""
    if get_mesh() is None or not is_sharded(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)
