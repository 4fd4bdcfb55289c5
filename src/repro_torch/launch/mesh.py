"""Device meshes of the port: a single-controller mesh of torch devices.

The reference's ``repro.launch.mesh`` builds a ``jax.sharding.Mesh`` and
runs one program over it with ``shard_map``.  The port's counterpart is
:class:`Mesh`, an array of ``torch.device``s with axis names, driven from
one host thread: each shard's tensors live on the shard's own device, as a
list in mesh order, and each collective (:func:`all_to_all`,
:func:`psum`) is explicit copies between those devices in a fixed shard
order.  A device may appear more than once: ``[cpu] * 4`` is the
counterpart of the reference's four forced host devices, and
``[cuda:0] * 4`` is four logical shards on one card.  Shards on one device
never share storage: every collective writes new tensors.

No ``torch.distributed`` process group is made here (the reference has
none either: one controller).  ``Mesh.shape`` is shaped like the
reference's (an ordered mapping from axis name to size).

Model parallelism (``repro_torch.distributed``) runs one rank per process
(or per thread) instead, over a named
``torch.distributed.device_mesh.DeviceMesh``: :func:`device_mesh` builds
one over a process group the caller has initialised, and
:func:`rank_device` names the device of the calling rank.

Building a mesh is a function call, never an import side effect.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh",
           "visible_devices", "check_devices", "all_to_all", "psum",
           "map_shards", "device_mesh", "rank_device"]


def visible_devices(kind="cuda") -> list:
    """Every visible device of ``kind``'s type: each CUDA card for a CUDA
    device (none on a host without one), the one CPU device for the
    CPU."""
    dev = torch.device(kind)
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(dev.type)]


def check_devices(devices) -> list:
    """``devices`` as a list of ``torch.device`` with explicit CUDA
    indices.  Raises :class:`ValueError` for an empty list and for a
    device that does not exist on this host; a device may repeat."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            idx = d.index
            if idx is None and n:
                idx = torch.cuda.current_device()
            if idx is None or idx >= n:
                raise ValueError(f"device {d} does not exist on this host "
                                 f"({n} CUDA devices visible)")
            d = torch.device("cuda", idx)
        elif d.type != "cpu":
            raise ValueError(f"device {d}: only cpu and cuda devices shard")
        out.append(d)
    if not out:
        raise ValueError("no devices given")
    return out


class Mesh:
    """An array of torch devices with named axes (the reference's
    ``jax.sharding.Mesh``, for one controller).

    ``devices`` is a numpy object array of ``torch.device`` whose shape is
    the mesh's; ``axis_names`` names its axes in order.
    """

    def __init__(self, devices, axis_names):
        devs = list(np.asarray(devices, dtype=object).ravel())
        shape = np.shape(np.asarray(devices, dtype=object))
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis names {names} for a mesh of shape "
                             f"{shape}")
        arr = np.empty((len(devs),), dtype=object)
        arr[:] = check_devices(devs)
        self.devices = arr.reshape(shape)
        self.axis_names = names

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, in axis order."""
        return collections.OrderedDict(
            zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def devices_along(self, axis: str) -> list:
        """The devices of ``axis`` in mesh order: the line along it
        through index 0 of every other axis (the group a collective over
        ``axis`` spans)."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in {self.axis_names}")
        k = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == k else 0
                    for i in range(len(self.axis_names)))
        return list(self.devices[idx])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh for tests and examples: the first
    ``data * model`` visible CUDA cards, or the first ``data * model`` of
    ``devices`` (which may repeat a device: ``[cpu] * 4`` or
    ``[cuda:0] * 4`` are four logical shards)."""
    n = data * model
    devs = (visible_devices("cuda") if devices is None
            else check_devices(devices))
    if len(devs) < n:
        raise RuntimeError(f"{n} devices needed for a {data} x {model} "
                           f"mesh, found {len(devs)}")
    arr = np.empty((n,), dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh over the visible CUDA cards: 16 x 16
    ``("data", "model")``, or 2 x 16 x 16 ``("pod", "data", "model")``
    with ``multi_pod``.  Raises :class:`RuntimeError` naming the device
    count it needs when fewer cards are visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devs = visible_devices("cuda")
    if len(devs) < n:
        raise RuntimeError(f"{n} devices needed, found {len(devs)}")
    arr = np.empty((n,), dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), axes)


def device_mesh(data: int, model: int, device_type: str = "cuda", *,
                pod: int | None = None):
    """A named ``DeviceMesh`` of ``(data, model)`` ranks in rank order, or
    of ``(pod, data, model)`` with ``pod`` (the reference's multi-pod
    mesh), over the default process group, which the caller has
    initialised with as many ranks (NCCL under ``torchrun``, ``gloo``
    processes, ranks as threads, or the dry run's ``fake`` group)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (data, model) if pod is None else (pod, data, model)
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(
        shape), mesh_dim_names=names)


def rank_device(device_mesh) -> torch.device:
    """The calling rank's device on ``device_mesh``: the current card of
    a CUDA mesh (one card per rank, or one card shared by ranks run as
    threads), else the mesh's device type."""
    if device_mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_mesh.device_type)


def _group(mesh: Mesh, axis: str, xs) -> list:
    """The devices of ``axis``, checked against one tensor per shard, each
    on its shard's device."""
    devs = mesh.devices_along(axis)
    if len(xs) != len(devs):
        raise ValueError(f"{len(xs)} shards for axis {axis!r} of "
                         f"{len(devs)} devices")
    for s, (x, dev) in enumerate(zip(xs, devs)):
        if x.device != dev:
            raise ValueError(f"shard {s} is on {x.device}, its mesh device "
                             f"is {dev}")
    return devs


def all_to_all(xs, mesh: Mesh, axis: str) -> list:
    """Tiled all-to-all over ``axis``, split and concatenated on axis 0
    (``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``): each shard's
    tensor is cut into S equal pieces along axis 0, and shard d receives
    the d-th piece of every shard, concatenated in shard order, on its
    own device."""
    devs = _group(mesh, axis, xs)
    s = len(devs)
    for x in xs:
        if x.shape[0] % s:
            raise ValueError(f"axis 0 of length {x.shape[0]} does not split "
                             f"over {s} shards")
    out = []
    for d, dev in enumerate(devs):
        parts = []
        for x in xs:
            k = x.shape[0] // s
            parts.append(x[d * k:(d + 1) * k].to(dev))
        out.append(torch.cat(parts))
    return out


def psum(xs, mesh: Mesh, axis: str) -> list:
    """Sum over ``axis`` (``jax.lax.psum``): shard d receives the sum of
    every shard's tensor on its own device, added in shard order."""
    devs = _group(mesh, axis, xs)
    out = []
    for dev in devs:
        acc = xs[0].to(dev, copy=True)
        for x in xs[1:]:
            acc += x.to(dev)
        out.append(acc)
    return out


def map_shards(fn, trees: list) -> list:
    """Apply a collective leaf by leaf: ``trees`` holds one tree (dicts,
    lists and tuples of tensors) per shard, all of one structure, and
    ``fn`` maps the list of one leaf's per-shard tensors to a list of
    per-shard results (``lambda xs: psum(xs, mesh, axis)``).  Returns one
    tree per shard."""
    t0 = trees[0]
    if isinstance(t0, dict):
        outs = {k: map_shards(fn, [t[k] for t in trees]) for k in t0}
        return [{k: outs[k][s] for k in t0} for s in range(len(trees))]
    if isinstance(t0, (list, tuple)):
        outs = [map_shards(fn, [t[i] for t in trees])
                for i in range(len(t0))]
        return [type(t0)(o[s] for o in outs) for s in range(len(trees))]
    return fn(list(trees))
