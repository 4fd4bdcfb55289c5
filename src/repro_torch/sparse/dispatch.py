"""Active-message bucketing on one device: the MoE token -> expert dispatch.

The port of ``bucketize``, ``unbucketize`` and ``steal_overflow`` from the
reference's ``repro/sparse/dispatch.py``, integer-exact (held bit-equal to
the reference by ``tests/test_torch_dispatch.py``).  A work item is a
message with a destination bucket (-1 = dead); each bucket holds
``capacity`` slots (the router buffer), and overflow is either dropped
(backpressure) or re-routed to the idlest buckets (opportunistic load
stealing, the paper's section 3.1.3).

Everything is static-shaped and free of host syncs, so it runs on the
card between kernels without stalling the stream.  The multi-device half
of the reference module (``am_dispatch``, ``am_respond``,
``shard_csr_rows``, ``spmv_sharded``) is not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["bucketize", "unbucketize", "steal_overflow"]


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
    return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype,
                                                  device=out.device))


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
