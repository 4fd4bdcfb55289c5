"""Parameter / activation sharding rules.

The port of the reference's ``repro/distributed/sharding.py``.  The
2-D logical layout of the production mesh:

  * ``data``  -- FSDP/ZeRO axis: weights, gradients and optimizer state
    are sharded here and gathered per layer where they are used;
  * ``model`` -- tensor-parallel axis: Megatron column/row splits, expert
    parallelism for MoE, and the *sequence* axis of decode KV caches;
  * ``pod``   -- composes with ``data`` for the batch; parameters are
    replicated across pods.

Rules are by parameter *name* (the leaf dict key), with a divisibility
check that silently drops an axis that does not divide the dimension
(e.g. HuBERT's 504-way vocab head).

The specs are pure functions of the mesh's ordered axis name -> size map:
:func:`spec_for`, :func:`param_specs`, :func:`batch_axes`,
:func:`batch_spec` and :func:`cache_specs` read nothing else, and take
anything that yields that map (:func:`axis_sizes`): a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, the port's
single-controller :class:`repro_torch.launch.mesh.Mesh`, or any object
with a ``shape`` mapping.  A spec is a :class:`P`, one entry per dim:
``None``, an axis name, or a tuple of names.

The port's parameters are per-layer modules, not stacked
(:class:`repro_torch.models.lm.LM`), so a layer leaf's spec is the
reference's spec of the stacked leaf without its leading ``None``.  The
caches keep the reference's leading layer axis, so their specs are the
reference's.

Sharded tensors are ``DTensor``s: :func:`placements` turns a spec into
DTensor placements on a named ``DeviceMesh``, and :func:`place_params`
distributes a model leaf by leaf from its unsharded tensors.
"""
from __future__ import annotations

import collections
import collections.abc
import math

import torch

# name -> spec for the *trailing* dims
_RULES_2D = {
    # (in, out) column-parallel
    "e": ("data", "model"),
    "w": ("data", "model"),          # unembed / head
    "wq": ("data", "model"), "wk": ("data", "model"),
    "wv": ("data", "model"), "wi": ("data", "model"),
    "wg": ("data", "model"), "wup": ("data", "model"),
    "wqkv": ("data", "model"), "win": ("data", "model"),
    "w1": ("data", "model"), "proj": ("data", "model"),
    # (in, out) row-parallel
    "wo": ("model", "data"), "wdown": ("model", "data"),
    "wout": ("model", "data"), "w2": ("model", "data"),
    # MLA specials
    "wdkv": ("data", None), "wukv": (None, "model"),
    # small / oddly-shaped
    "wif": ("data", None), "conv": (None, "model"),
    "router": ("data", None),
}
# MoE expert-stacked (E, in, out): experts over 'model' (EP)
_RULES_3D = {
    "wi": ("model", "data", None), "wg": ("model", "data", None),
    "wo": ("model", None, "data"),
}


class P(tuple):
    """A partition spec: one entry per dim, each ``None``, a mesh axis
    name or a tuple of names (the reference's ``PartitionSpec``, which
    also writes a tuple of one name as the name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> collections.OrderedDict:
    """The mesh's ordered axis name -> size map: a ``DeviceMesh``'s named
    dims, or the ``shape`` mapping of any other mesh."""
    if isinstance(mesh.shape, collections.abc.Mapping):
        return collections.OrderedDict(mesh.shape)
    return collections.OrderedDict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(ax) -> tuple:
    return ax if isinstance(ax, tuple) else (ax,)


def _fits(axes, shape, mesh) -> tuple:
    """Drop mesh axes that do not divide the corresponding dim."""
    sizes = axis_sizes(mesh)
    out = []
    for ax, dim in zip(axes, shape):
        if ax is None:
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in _names(ax))
        out.append(ax if dim % size == 0 else None)
    return tuple(out)


def spec_for(path: tuple, shape: tuple, mesh) -> P:
    """The spec of one parameter leaf (``path`` its keys, the last its
    name; ``shape`` the leaf's own, no layer axis)."""
    name = path[-1]
    nd = len(shape)
    if nd == 1 or name in ("g", "a_log", "dt_bias"):
        return P()
    base = _RULES_3D.get(name) if nd == 3 and name in _RULES_3D else \
        _RULES_2D.get(name)
    if base is None:
        base = ("data", "model") if nd >= 2 else (None,)
    lead = nd - len(base)
    return P(*((None,) * lead + _fits(base, shape[lead:], mesh)))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested tree of dicts and lists (a list
    index is part of the path, a dict key too)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, (P, NamedSharding)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _as_tree(params):
    return params.tree() if hasattr(params, "tree") else params


def param_specs(params_like, mesh):
    """The :class:`P` of every leaf of a model (an ``LM`` or its
    ``tree()``), as a tree of the same structure."""
    return _map_with_path(
        lambda path, x: spec_for(
            tuple(k for k in path if isinstance(k, str)), tuple(x.shape),
            mesh),
        _as_tree(params_like))


def batch_axes(mesh) -> tuple:
    """Mesh axes composing the global batch dimension."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def batch_spec(mesh) -> P:
    return P(batch_axes(mesh))


def cache_specs(caches_like, mesh, *, long_context: bool = False):
    """KV / state cache specs (sequence over 'model'; batch over 'data';
    long-context batch=1 shards the sequence over both axes), for
    :func:`repro_torch.models.lm.make_caches`' trees (a leading layer
    axis)."""
    seq_axes = ("data", "model") if long_context else "model"
    batch_ax = None if long_context else "data"

    def spec(path, x) -> P:
        name = path[-1]
        shape = tuple(x.shape)
        nd = len(shape)
        if name in ("k", "v"):
            # (L?, B, KV, S, hd) or (n_apps, B, KV, S, hd) or (B, KV, S, hd)
            lead, base = nd - 4, (batch_ax, None, seq_axes, None)
        elif name in ("ckv", "kr"):          # (L?, B, S, d)
            lead, base = nd - 3, (batch_ax, seq_axes, None)
        elif name == "h":                    # mamba state (L?,B,nh,hp,ds)
            lead, base = nd - 4, (batch_ax, "model", None, None)
        elif name == "conv":                 # (L?, B, k, di)
            lead, base = nd - 3, (batch_ax, None, "model")
        elif name == "c" and nd >= 4:        # mlstm (nm, B, H, hp, hp)
            lead, base = nd - 4, (batch_ax, None, "model", None)
        elif name == "c":                    # slstm (ns, B, D)
            lead, base = nd - 2, (batch_ax, "model")
        elif name == "n":                    # mlstm norm (nm, B, H, hp)
            lead, base = nd - 3, (batch_ax, None, "model")
        else:
            return P()
        return P(*((None,) * lead + _fits(base, shape[lead:], mesh)))

    return _map_with_path(spec, caches_like)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
def placements(spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on a named ``DeviceMesh``: one per
    mesh dim, ``Shard(d)`` where tensor dim ``d`` names that mesh dim
    (alone or in a tuple), ``Replicate()`` elsewhere.  A dim split over
    several axes is split in the order of the mesh's dims (major to
    minor), the reference's order for a tuple of axes in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in _names(ax):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


class NamedSharding(tuple):
    """A mesh and the placements of a tensor on it (the reference's
    ``NamedSharding``): what :func:`place` distributes a tensor by."""

    def __new__(cls, mesh, placements):
        return super().__new__(cls, (mesh, tuple(placements)))

    @property
    def mesh(self):
        return self[0]

    @property
    def placements(self) -> tuple:
        return self[1]


def named(spec, device_mesh) -> NamedSharding:
    return NamedSharding(device_mesh, placements(spec, device_mesh))


def param_shardings(params_like, device_mesh):
    """The :class:`NamedSharding` of every leaf of a model on
    ``device_mesh`` (a tree of the model's ``tree()`` structure)."""
    return _map_with_path(lambda _, s: named(s, device_mesh),
                          param_specs(params_like, device_mesh))


def batch_sharding(device_mesh, shape) -> NamedSharding:
    """The :class:`NamedSharding` of a batch tensor of ``shape``: its
    leading dim over :func:`batch_axes` where they divide it, the rest
    whole on every rank."""
    spec = _fits(batch_spec(device_mesh), tuple(shape[:1]), device_mesh)
    return named(spec, device_mesh)


def place(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the whole tensor, the same on every rank) as a ``DTensor``
    with ``sharding``: each rank keeps a copy of its own slice.  Nothing
    is communicated and nothing is drawn from DTensor's RNG, so a placed
    model holds exactly the values it was given."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    d = distribute_tensor(x.detach(), sharding.mesh, sharding.placements,
                          src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), sharding.mesh,
                              sharding.placements, shape=d.shape,
                              stride=d.stride())


def local_box(shape, device_mesh, placements) -> tuple:
    """(offsets, sizes) of the calling rank's shard of a tensor of
    ``shape`` placed by ``placements``: each mesh dim that splits a
    tensor dim, in mesh order, takes ``torch.chunk``'s piece of what the
    earlier ones left (DTensor's layout).  Computed on the host: torch's
    own helper builds a tensor of the offsets, which a fake tensor cannot
    read back."""
    from torch.distributed.tensor import Shard
    coord = device_mesh.get_coordinate()
    offsets, sizes = [0] * len(shape), list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n = sizes[p.dim]
            step = -(-n // device_mesh.size(m))
            start = min(coord[m] * step, n)
            offsets[p.dim] += start
            sizes[p.dim] = min(step, n - start)
    return tuple(offsets), tuple(sizes)


def place_params(params, device_mesh):
    """A model (an ``LM``) distributed leaf by leaf on ``device_mesh`` by
    :func:`param_shardings`: a new ``LM`` whose parameters are
    ``DTensor``s; the given model is left as it is."""
    from repro_torch.models.lm import LM
    return LM(_zip_map(place, params.tree(),
                       param_shardings(params, device_mesh)))


def place_caches(caches, device_mesh, *, long_context: bool = False):
    """Decode caches (``lm.make_caches``' tree) distributed by
    :func:`cache_specs`; with ``long_context`` (a batch of one) the
    sequence is split over ``("data", "model")`` and the batch whole."""
    specs = cache_specs(caches, device_mesh, long_context=long_context)
    return _zip_map(lambda x, s: place(x, named(s, device_mesh)), caches,
                    specs)


def zero_caches(caches_like, device_mesh, device, *,
                long_context: bool = False):
    """Zero decode caches of the shapes and dtypes of ``caches_like`` (a
    tree of ``lm.make_caches``' structure, on any device, ``meta`` too)
    as ``DTensor``s placed by :func:`cache_specs` (``long_context`` as
    there), each made from the calling rank's own zero shard on
    ``device``: the whole cache never exists on any rank.  Caches that
    already hold values are placed by :func:`place_caches`."""
    from torch.distributed.tensor import DTensor

    def zeros(x, spec):
        sharding = named(spec, device_mesh)
        _, local = local_box(x.shape, device_mesh, sharding.placements)
        return DTensor.from_local(
            torch.zeros(local, dtype=x.dtype, device=device), device_mesh,
            sharding.placements, shape=x.shape, stride=_contiguous(x.shape))

    return _zip_map(zeros, caches_like, cache_specs(
        caches_like, device_mesh, long_context=long_context))


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def _zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure (the
    other's leaves may be tuples: :class:`P`, :class:`NamedSharding`)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)
