"""Active-message dispatch: the MoE token -> expert bucketing on one
device, and the paper's T1/T2/T3 flow across the shards of a mesh.

The port of the reference's ``repro/sparse/dispatch.py``, integer-exact
(held bit-equal to the reference by ``tests/test_torch_dispatch.py``).  A
work item is a message with a destination bucket (-1 = dead); each bucket
holds ``capacity`` slots (the router buffer), and overflow is either
dropped (backpressure) or re-routed to the idlest buckets (opportunistic
load stealing, the paper's section 3.1.3).

``bucketize``, ``unbucketize`` and ``steal_overflow`` are static-shaped
and free of host syncs, so they run on the card between kernels without
stalling the stream.  ``am_dispatch`` / ``am_respond`` route records
between the shards of a :class:`repro_torch.launch.mesh.Mesh` (one list
entry per shard, on the shard's device) through its explicit
``all_to_all`` and ``psum``, where the reference runs inside
``shard_map``; ``shard_csr_rows`` and ``spmv_sharded`` are the
distributed SpMV of the paper's Fig. 5 on top of them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, all_to_all, map_shards, psum

__all__ = ["bucketize", "unbucketize", "steal_overflow", "am_dispatch",
           "am_respond", "shard_csr_rows", "spmv_sharded"]


def _rank_in_bucket(dest: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(L,) int64: how many earlier items share each item's bucket (0 for
    a dead item, whose one-hot row is empty)."""
    onehot = dest[:, None] == torch.arange(n_shards, device=dest.device)
    rank = torch.cumsum(onehot, dim=0) - 1
    return torch.where(onehot, rank, 0).sum(dim=1)


def bucketize(dest: torch.Tensor, n_shards: int, capacity: int):
    """Pack work items into per-destination buckets (static shapes).

    Args:
      dest: (L,) int32 destination bucket of each item (-1 = dead).
    Returns:
      idx:   (n_shards, capacity) int32 — item index per bucket slot.
      valid: (n_shards, capacity) bool.
      rank:  (L,) int32 — slot each item took within its bucket.
      kept:  (L,) bool — False where the bucket overflowed (backpressure).
    """
    length = dest.shape[0]
    dev = dest.device
    rank = _rank_in_bucket(dest, n_shards)
    kept = (dest >= 0) & (rank < capacity)
    # the reference scatters dropped items out of bounds (mode="drop"):
    # here they all land in one spare row/column that is cut off after
    d = torch.where(kept, dest.long(), n_shards)
    r = torch.where(kept, rank, capacity)
    idx = torch.zeros((n_shards + 1, capacity + 1), dtype=torch.int32,
                      device=dev)
    valid = torch.zeros((n_shards + 1, capacity + 1), dtype=torch.bool,
                        device=dev)
    idx.index_put_((d, r), torch.arange(length, dtype=torch.int32,
                                         device=dev))
    valid.index_put_((d, r), torch.ones((), dtype=torch.bool, device=dev))
    return (idx[:n_shards, :capacity], valid[:n_shards, :capacity],
            rank.to(torch.int32), kept)


def unbucketize(bucketed: torch.Tensor, dest: torch.Tensor,
                rank: torch.Tensor, kept: torch.Tensor,
                fill=0) -> torch.Tensor:
    """Inverse of :func:`bucketize` for per-item results."""
    d = torch.where(kept, dest, 0).long()
    r = torch.where(kept, rank, 0).long()
    out = bucketed[d, r]
    mask = kept.reshape(kept.shape + (1,) * (out.dim() - 1))
    return torch.where(mask, out, fill)


def steal_overflow(dest: torch.Tensor, load: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Opportunistic re-routing: overflow items go to the idlest buckets.

    Args:
      dest: (L,) requested destination per item.
      load: (S,) global per-destination demand.
    Returns the adjusted destinations (``dest``'s dtype).  Deterministic:
    the i-th overflow item (in item order) goes to the first bucket whose
    cumulative free capacity exceeds i — the reference's greedy fill.
    """
    n_shards = load.shape[0]
    free = torch.clamp(capacity - load.long(), min=0)
    rank = _rank_in_bucket(dest, n_shards)
    over = (dest >= 0) & (rank >= capacity)
    over_rank = torch.cumsum(over.long(), dim=0) - 1
    cumfree = torch.cumsum(free, dim=0)
    new_dest = torch.searchsorted(cumfree, over_rank + 1, right=False)
    new_dest = new_dest.clamp(0, n_shards - 1).to(dest.dtype)
    return torch.where(over, new_dest, dest)


def am_dispatch(items: list, dest: list, *, mesh: Mesh, axis: str,
                capacity: int, opportunistic: bool = False):
    """Route work-item records to their owning shard over ``axis``.

    Args:
      items: one tree of (L, ...) tensors per shard (the message
        payloads), on the shard's device.
      dest: one (L,) int32 tensor of owning-shard ids per shard (-1 =
        dead).
      opportunistic: psum every shard's histogram of live destinations
        into the global load and re-route overflow with
        :func:`steal_overflow` before bucketing.
    Returns ``(recv, rvalid, meta)``, each a list with one entry per
    shard: the received payloads, trees of (S, capacity, ...) tensors
    (``recv[d][s]`` came from shard ``s``); the (S, capacity) bool
    validity; and the routing state for :func:`am_respond`.
    """
    # imported here: repro_torch.train imports the models, which import
    # this module
    from repro_torch.train.optimizer import tree_map
    devs = mesh.devices_along(axis)
    n_shards = len(devs)
    if len(items) != n_shards or len(dest) != n_shards:
        raise ValueError(f"{len(items)} item trees and {len(dest)} "
                         f"destination vectors for {n_shards} shards")
    if opportunistic:
        hists = []
        for d in dest:
            hist = torch.zeros((n_shards,), dtype=torch.int32,
                               device=d.device)
            hists.append(hist.index_add_(0, d.clamp(min=0).long(),
                                         (d >= 0).to(torch.int32)))
        loads = psum(hists, mesh, axis)
        dest = [steal_overflow(d, ld, capacity)
                for d, ld in zip(dest, loads)]
    routes = [bucketize(d, n_shards, capacity) for d in dest]

    def pack(x, idx, valid):
        picked = x[idx.long()]                               # (S, cap, ...)
        mask = valid.reshape(valid.shape + (1,) * (picked.dim() - 2))
        return torch.where(mask, picked, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))

    send = [tree_map(lambda x, r=r: pack(x, r[0], r[1]), it)
            for it, r in zip(items, routes)]
    recv = map_shards(lambda xs: all_to_all(xs, mesh, axis), send)
    # valid travels as int32 and comes back as bool, as in the reference
    rvalid = [v.bool() for v in all_to_all(
        [r[1].to(torch.int32) for r in routes], mesh, axis)]
    meta = [(d, r[2], r[3]) for d, r in zip(dest, routes)]
    return recv, rvalid, meta


def am_respond(results: list, meta: list, *, mesh: Mesh, axis: str) -> list:
    """Send per-received-item results (one tree of (S, capacity, ...)
    tensors per shard) back to the requesting shards: each shard gets its
    own items' results in item order, ``fill`` (0) for items its buckets
    dropped."""
    from repro_torch.train.optimizer import tree_map
    back = map_shards(lambda xs: all_to_all(xs, mesh, axis), results)
    return [tree_map(lambda x, m=m: unbucketize(x, *m), b)
            for b, m in zip(back, meta)]


# ----------------------------------------------------------------------------
# Distributed SpMV: the paper's Fig. 5 flow over the shards of a mesh.
# ----------------------------------------------------------------------------
def shard_csr_rows(a_dense: np.ndarray, n_shards: int, *,
                   nnz_cap: int | None = None) -> dict:
    """nnz-balanced contiguous row partition (paper section 3.1.1) ->
    stacked per-shard CSR arrays, numpy only (the reference's dict, byte
    for byte).

    Returns a dict of stacked arrays and the row boundaries.
    """
    from repro_torch.core.partition import nnz_balanced_rows

    a_dense = np.asarray(a_dense)
    m, n = a_dense.shape
    rowptr = np.zeros((m + 1,), np.int64)
    rows, cols = np.nonzero(a_dense)
    np.add.at(rowptr, rows + 1, 1)
    rowptr = np.cumsum(rowptr)
    place = nnz_balanced_rows(rowptr, n_shards)
    bounds = np.searchsorted(place.row_to_pe, np.arange(n_shards + 1))
    rows_per = int(max(np.diff(bounds).max(), 1))
    caps = [int((place.row_to_pe[rows] == s).sum()) for s in range(n_shards)]
    cap = nnz_cap or max(max(caps), 1)

    s_rowptr = np.zeros((n_shards, rows_per + 1), np.int32)
    s_col = np.zeros((n_shards, cap), np.int32)
    s_val = np.zeros((n_shards, cap), a_dense.dtype)
    s_nnz = np.zeros((n_shards,), np.int32)
    s_rows = np.zeros((n_shards,), np.int32)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        sel = (rows >= lo) & (rows < hi)
        r, c = rows[sel] - lo, cols[sel]
        s_nnz[s] = r.size
        s_rows[s] = hi - lo
        s_col[s, :r.size] = c
        s_val[s, :r.size] = a_dense[rows[sel], cols[sel]]
        rp = np.zeros((rows_per + 1,), np.int32)
        np.add.at(rp, r + 1, 1)
        s_rowptr[s] = np.cumsum(rp)
    return dict(rowptr=s_rowptr, col=s_col, val=s_val, nnz=s_nnz,
                nrows=s_rows, bounds=bounds, rows_per=rows_per, cap=cap,
                n=n)


def spmv_sharded(mesh: Mesh, shards: dict, x, *, axis: str = "data",
                 capacity: int | None = None,
                 opportunistic: bool = False) -> np.ndarray:
    """y = A @ x with A row-sharded (nnz-balanced, :func:`shard_csr_rows`)
    and x sharded over ``axis``: the AM flow.  Returns the flat (m,) f32
    numpy vector, as the reference does.

    T1: each shard emits one message per local nonzero (value + column).
    T2: the column owner multiplies against its x shard (data-local).
    T3: the response returns to the row owner and is added into y (an
    f32 ``index_add_``: in item order on the CPU, by atomics, in no fixed
    order, on the card).

    ``opportunistic`` load stealing preserves the result only where
    ``capacity`` covers the worst bucket (then it is a no-op): the T2 hop
    is a memory op bound to the x owner, as the reference says.
    """
    devs = mesh.devices_along(axis)
    n_shards = len(devs)
    n = int(shards["n"])
    if n % n_shards:
        raise ValueError(f"x of {n} does not shard evenly over {n_shards}")
    xs = n // n_shards
    cap = capacity or int(shards["cap"])
    rows_per = int(shards["rows_per"])
    x_parts = np.asarray(x).reshape(n_shards, xs)
    items, dest, rows_of, lives, x_local = [], [], [], [], []
    for s, dev in enumerate(devs):
        rowptr = torch.tensor(shards["rowptr"][s], device=dev)
        col = torch.tensor(shards["col"][s], device=dev)
        val = torch.tensor(shards["val"][s], device=dev)
        ar = torch.arange(col.shape[0], dtype=torch.int32, device=dev)
        live = ar < int(shards["nnz"][s])
        dest.append(torch.where(live, col // xs, -1))
        rows_of.append((torch.searchsorted(rowptr, ar, right=True) - 1)
                       .clamp(0, rows_per - 1))
        lives.append(live)
        items.append({"val": val, "off": col % xs})
        x_local.append(torch.tensor(x_parts[s], device=dev))
    recv, rvalid, meta = am_dispatch(items, dest, mesh=mesh, axis=axis,
                                     capacity=cap,
                                     opportunistic=opportunistic)
    # T2 at the owner: multiply against the local x shard
    prod = [torch.where(rv, r["val"].float() * xl[r["off"].long()].float(),
                        0.0)
            for r, rv, xl in zip(recv, rvalid, x_local)]
    # T3: the response home, accumulated into the local output rows
    back = am_respond(prod, meta, mesh=mesh, axis=axis)
    bounds = shards["bounds"]
    parts = []
    for s, (b, row_of, live) in enumerate(zip(back, rows_of, lives)):
        y = torch.zeros((rows_per,), dtype=torch.float32, device=b.device)
        y.index_add_(0, row_of.long(), torch.where(live, b, 0.0))
        parts.append(y[:int(bounds[s + 1] - bounds[s])].cpu().numpy())
    return np.concatenate(parts) if parts else np.zeros((0,))
