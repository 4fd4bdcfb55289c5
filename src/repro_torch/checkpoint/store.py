"""Step-atomic checkpoints of tensor trees — a port of the reference's
``repro.checkpoint.store`` with the same on-disk layout, so a checkpoint
written by either package restores in the other.

Layout (one directory per step, atomic rename commit):

    <root>/step_00001230.tmp/   (during write)
    <root>/step_00001230/       (after commit)
        tree.json               # tree structure + leaf metadata
        leaf_00000.npy ...      # one .npy per leaf (row-major, full array)
        _COMPLETE               # commit marker

* **Step-atomic**: readers only consider directories with the commit
  marker, so a crash mid-save never corrupts the latest checkpoint.
* **Leaf order** is the reference's tree flatten order: dict keys sorted,
  lists and tuples (``NamedTuple`` states included) in order, ``None`` an
  empty subtree.  Leaves may be tensors, numpy arrays or scalars.
* **bfloat16 without ml_dtypes**: ``.npy`` only round-trips numpy's own
  dtypes, so a ``torch.bfloat16`` leaf is stored as its raw
  unsigned bits with the dtype's name in ``ml_dtype``, as the reference
  stores an ``ml_dtypes`` leaf, and restored by viewing the bits back.
* **Async save**: :meth:`CheckpointManager.save` with ``blocking=False``
  copies every leaf to host memory before it returns (the only
  synchronous part) and writes on a daemon thread.
* **Sharded trees**: a ``DTensor`` leaf is gathered whole before it is
  written, so the files hold the reference's full arrays whatever the
  mesh.  Every rank takes part in the gathers; the mesh's first rank
  writes, and the others wait for its commit (a barrier of the default
  process group in :meth:`CheckpointManager.wait`).
* **Restore onto a device or a mesh (the elastic reshard)**:
  :func:`restore_checkpoint` puts every leaf on ``device=``, or, with
  ``shardings=`` (a tree of
  :class:`repro_torch.distributed.sharding.NamedSharding`, or one for
  every leaf; None for a plain leaf), distributes each leaf onto any
  mesh and placements, whatever mesh saved it.
* **Retention**: the ``keep`` newest checkpoints are kept, older ones
  pruned after a successful commit.
* **Pipeline state**: JSON-able ``extra`` rides in ``tree.json``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.context import is_sharded
from repro_torch.distributed.sharding import NamedSharding, place

_MARKER = "_COMPLETE"

_UINT_OF_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _to_host(x) -> tuple[np.ndarray, str | None]:
    """One leaf -> (a host numpy array that owns its memory, ml_dtype
    name or None); a raw-bits leaf comes back as unsigned ints, and a
    ``DTensor`` whole (a collective: every rank calls it)."""
    if isinstance(x, torch.Tensor):
        if is_sharded(x):
            x = x.full_tensor()
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), None
    x = np.array(x, copy=True)
    if x.dtype.kind in "biufc":
        return x, None
    # an ml_dtypes array handed over from the reference
    return x.view(_UINT_OF_SIZE[x.dtype.itemsize]), x.dtype.name


class _TreeDef:
    """The structure :func:`_flatten` walked, able to rebuild it."""

    def __init__(self, kind, meta=None, children=()):
        self.kind, self.meta, self.children = kind, meta, list(children)

    @property
    def n_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.n_leaves for c in self.children)

    def unflatten(self, leaves):
        return self._build(iter(leaves))

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        vals = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, vals))
        if self.kind == "list":
            return vals
        if self.kind == "tuple":
            return tuple(vals)
        return self.meta(*vals)        # a NamedTuple class

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(str(c) for c in self.children)
        if self.kind == "dict":
            return "{" + ", ".join(f"'{k}': {c}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind == "list":
            return f"[{inner}]"
        if self.kind == "tuple":
            return f"({inner})"
        return f"{self.meta.__name__}({inner})"


def _flatten(tree) -> tuple[list, _TreeDef]:
    """Leaves in the reference's flatten order, and the structure."""
    leaves: list = []

    def walk(t) -> _TreeDef:
        if t is None:
            return _TreeDef("none")
        if isinstance(t, dict):
            keys = sorted(t)
            return _TreeDef("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return _TreeDef("namedtuple", type(t), [walk(v) for v in t])
        if isinstance(t, (list, tuple)):
            return _TreeDef("list" if isinstance(t, list) else "tuple",
                            None, [walk(v) for v in t])
        leaves.append(t)
        return _TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _write(root: str, step: int, host: list, treedef: _TreeDef,
           extra: dict | None) -> str:
    """Commit host leaves (``(array, ml_dtype)`` pairs) as one step."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    meta = {
        "step": int(step),
        "treedef": str(treedef),
        "n_leaves": len(host),
        "leaves": [dict(shape=list(x.shape),
                        dtype=ml if ml is not None else str(x.dtype),
                        ml_dtype=ml) for x, ml in host],
        "extra": extra or {},
    }
    for i, (x, _) in enumerate(host):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), x)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _writes(leaves) -> bool:
    """Whether this rank writes a tree with these leaves: always for a
    plain tree, only the first rank of the mesh for a sharded one."""
    mesh = next((x.device_mesh for x in leaves if is_sharded(x)), None)
    return mesh is None or mesh.get_rank() == int(mesh.mesh.min())


def save_checkpoint(root: str, step: int, tree, *, extra: dict | None = None
                    ) -> str:
    """Synchronous step-atomic save.  Returns the committed directory.
    A sharded tree is gathered on every rank, written by the mesh's first
    and committed for all at a barrier."""
    leaves, treedef = _flatten(tree)
    host = [_to_host(x) for x in leaves]
    final = os.path.join(root, f"step_{step:08d}")
    if _writes(leaves):
        final = _write(root, step, host, treedef, extra)
    if any(is_sharded(x) for x in leaves):
        torch.distributed.barrier()
    return final


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(root, name, _MARKER)):
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                continue   # stray step_* entry that isn't a checkpoint
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _per_leaf(tree_like, shardings) -> list:
    """The sharding of each leaf of ``tree_like`` in flatten order: a
    :class:`NamedSharding` or None where ``shardings`` has one applies to
    the whole subtree below it."""
    out: list = []

    def walk(t, s):
        one = s is None or isinstance(s, NamedSharding)
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s if one else s[k])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, s if one else s[i])
        else:
            out.append(s)

    walk(tree_like, shardings)
    return out


def _load_leaf(x: np.ndarray, ml_name: str | None, device) -> torch.Tensor:
    """A stored array -> a tensor on ``device`` that owns its memory."""
    if ml_name is None:
        return torch.tensor(x, device=device)
    if ml_name != "bfloat16":
        raise ValueError(f"leaf dtype {ml_name!r} has no torch type here")
    return torch.tensor(x.view(np.int16)).view(torch.bfloat16).to(device)


def restore_checkpoint(root: str, tree_like, *, step: int | None = None,
                       device="cuda", shardings=None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like``, every leaf a tensor on
    ``device`` or distributed by ``shardings``.

    Args:
      tree_like: a tree with the target structure (shapes are checked).
      step: the step to restore (default: the latest complete one).
      device: where the restored plain leaves live.
      shardings: optional tree of (or single) :class:`NamedSharding`;
        each leaf is placed with its own (an elastic reshard onto any
        mesh), a None leaf or subtree stays a plain tensor on ``device``.
    Returns:
      (tree, step, extra)
    """
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, _MARKER)):
        raise FileNotFoundError(f"checkpoint {d} is incomplete")
    with open(os.path.join(d, "tree.json")) as f:
        meta = json.load(f)
    leaves_like, treedef = _flatten(tree_like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, target structure "
            f"has {len(leaves_like)} — architecture mismatch")
    out = []
    for i, (like, sh) in enumerate(zip(leaves_like,
                                       _per_leaf(tree_like, shardings))):
        x = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        want = _shape(like)
        if tuple(x.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {x.shape} != "
                             f"target {want}")
        ml = meta["leaves"][i].get("ml_dtype")
        if sh is None:
            out.append(_load_leaf(x, ml, device))
        else:
            out.append(place(_load_leaf(x, ml, sh.mesh.device_type), sh))
    return treedef.unflatten(out), step, meta.get("extra", {})


class CheckpointManager:
    """Async-capable manager with retention.  One writer thread at a time."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sharded = False      # saved a sharded tree: ranks barrier
        os.makedirs(root, exist_ok=True)

    def wait(self):
        """Block until any in-flight async save commits (on every rank,
        once a sharded tree was saved)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = True):
        self.wait()
        # snapshot to host *now*, as copies, so the caller may update the
        # tensors in place (the engine does) as soon as this returns: a
        # CPU tensor's .numpy() is a view the next step would overwrite
        leaves, treedef = _flatten(tree)
        host = [_to_host(x) for x in leaves]
        self._sharded = any(is_sharded(x) for x in leaves)
        if not _writes(leaves):
            if blocking:
                self.wait()
            return

        def work():
            try:
                _write(self.root, step, host, treedef, extra)
                self._prune()
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore(self, tree_like, *, step: int | None = None, device="cuda",
                shardings=None):
        return restore_checkpoint(self.root, tree_like, step=step,
                                  device=device, shardings=shardings)

    def latest(self) -> int | None:
        return latest_step(self.root)

    def _prune(self):
        steps = list_steps(self.root)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
