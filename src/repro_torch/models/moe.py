"""Mixture-of-Experts with Active-Message dispatch.

The port of the reference's ``repro/models/moe.py``.  Token -> expert
routing is AM routing: each token is a message whose destination is the
expert owning the weights, the static capacity is the router buffer, and
opportunistic load stealing (paper section 3.1.3) re-routes overflow
tokens to the least-loaded experts instead of dropping them.  Dispatch
uses :mod:`repro_torch.sparse.dispatch`.

The three expert products (``wg``, ``wi``, ``wo``; the reference's
``ecd,edf->ecf`` einsums) run through :func:`grouped_expert_matmul`, the
hand-written grouped-matmul kernel on the card (differentiable: the
backward's dx runs the same kernel, dw ``torch.bmm``; the integer routing
carries no gradient, the gates and the router's probabilities do, as
under ``jax.grad`` in the reference).  The kernel returns f32;
its output is rounded to the activations' dtype first, as the reference's
einsum returns that dtype.  The reference's four sharding constraints
(``xe``, ``h``, the ``wi`` product and ``ye`` to experts on ``model``,
capacity on ``data``) are :func:`repro_torch.distributed.context
.constrain` calls: the identity without a mesh, a ``DTensor``
redistribution on one, where each expert product runs the kernel on the
rank's own experts under ``local_map``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import context as dctx
from repro_torch.kernels.group_matmul import grouped_expert_matmul
from repro_torch.models.layers import _init, _local, swiglu
from repro_torch.sparse.dispatch import (bucketize, steal_overflow,
                                         unbucketize)


def moe_init(gen, d, cfg, dtype=torch.bfloat16):
    p = {
        "router": _init(gen, (d, cfg.n_experts), dtype=torch.float32),
        "wi": _init(gen, (cfg.n_experts, d, cfg.d_expert), dtype=dtype),
        "wg": _init(gen, (cfg.n_experts, d, cfg.d_expert), dtype=dtype),
        "wo": _init(gen, (cfg.n_experts, cfg.d_expert, d),
                    scale=1.0 / math.sqrt(cfg.d_expert), dtype=dtype),
    }
    if cfg.n_shared:
        f = cfg.n_shared * max(cfg.d_shared, 1)
        p["shared"] = {
            "wi": _init(gen, (d, f), dtype=dtype),
            "wg": _init(gen, (d, f), dtype=dtype),
            "wo": _init(gen, (f, d), scale=1.0 / math.sqrt(f), dtype=dtype)}
    return p


def _segment_count(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(n,) count of each value of ``idx`` (a sync-free bincount)."""
    out = torch.zeros((n,), dtype=dtype, device=idx.device)
    return out.scatter_add_(0, idx.long(), torch.ones_like(idx, dtype=dtype))


def _choose(xt, router, cfg, cap):
    """The router of ``xt`` (T, D): its probabilities (T, E), each
    message's destination expert (T*k,) and the gates (T, k)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = xt.float() @ router                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = gate[:, :k], choice[:, :k]                # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    dest = choice.reshape(t * k).to(torch.int32)             # messages
    if cfg.load_steal:
        load = _segment_count(dest, e, torch.int32)
        dest = steal_overflow(dest, load, cap)
        # gates follow the message: a stolen token is weighted by the
        # router's probability for the expert that actually serves it
        gate = torch.gather(probs, -1, dest.reshape(t, k).long())
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, dest, gate


def _route(xt, router, cfg, cap):
    """The router and the AM dispatch of ``xt`` (T, D): returns the
    expert buffers ``xe`` (E, C, D), the gates (T, k), the messages'
    destinations, bucket ranks and kept flags, and the aux loss, expert
    utilisation and dropped fraction."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs, dest, gate = _choose(xt, router, cfg, cap)
    idx, valid, rank, kept = bucketize(dest, e, cap)         # AM buckets

    tok_of_slot = (idx // k).long()                          # (E, C)
    xe = torch.where(valid[..., None], xt[tok_of_slot], 0)   # (E, C, D)

    # Switch-style aux load-balance loss + utilization stats
    me = probs.mean(0)
    ce = _segment_count(dest, e, torch.float32) / (t * k)
    aux_loss = e * torch.sum(me * ce)
    util = (ce > 0).float().mean()
    dropped = 1.0 - kept.float().mean()
    return xe, gate, dest, rank, kept, aux_loss, util, dropped


def _combine(ye, gate, dest, rank, kept):
    """Each message's expert output back to its token, weighted by its
    gate and summed over the token's k messages: (T, D)."""
    t, k = gate.shape
    back = unbucketize(ye, dest, rank, kept)                 # (T*k, D)
    return (back.reshape(t, k, -1) * gate[..., None].to(ye.dtype)).sum(1)


def _replicated(fn, n_out: int, *args):
    """``fn`` on the whole of every ``DTensor`` argument, on every rank
    alike (``local_map`` with every placement ``Replicate``); its
    ``n_out`` outputs are replicated ``DTensor``s."""
    from torch.distributed.tensor import Replicate
    rep = (Replicate(),) * args[0].device_mesh.ndim
    return _local(fn, [rep] * n_out, *((a, rep) for a in args))


def _expert_product(xe, w):
    """``grouped_expert_matmul`` (E, C, D) @ (E, D, F).  On a mesh, the
    kernel runs under ``local_map`` on each rank's own experts: ``xe``
    keeps its placements (experts on ``model``, capacity on ``data``
    where it divides), and ``w`` is gathered over every axis but the
    experts' (a rank's dw then sums over its own capacity slots only: a
    partial sum over an axis that splits the capacity)."""
    if not dctx.is_sharded(xe):
        return grouped_expert_matmul(xe, w)
    from torch.distributed.tensor import Replicate, Shard
    x_place = tuple(xe.placements)
    w_place = tuple(p if p == Shard(0) else Replicate() for p in x_place)
    return _local(grouped_expert_matmul, [x_place], (xe, x_place),
                  (w, w_place))


def moe_apply(p, x, cfg, *, deterministic_capacity: int | None = None):
    """x: (B, S, D) -> (y, aux) with aux = load-balancing stats/loss.

    Static shapes throughout: tokens are bucketized per expert with
    capacity C = ceil(T*k/E * capacity_factor); overflow is re-routed
    (load_steal) or dropped.  The top-k takes the lower expert index on
    ties, as ``jax.lax.top_k`` does (a stable descending sort).

    On a mesh (``x`` a ``DTensor``) the router, the dispatch and the
    combine run on the whole token set on every rank (the reference's
    routing is global over the batch), and the expert buffers take the
    reference's constraints: experts on ``model``, capacity on ``data``.
    """
    b, s, d = x.shape
    t = b * s
    if dctx.is_sharded(x):
        # whole sequences on each rank (a sequence-parallel residual
        # stream): the router reads every token anyway
        x = dctx.constrain(x, dctx.batch_axes(), None, None)
    xt = x.reshape(t, d)
    cap = deterministic_capacity or int(
        math.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    route = lambda xt, router: _route(xt, router, cfg, cap)  # noqa: E731
    if dctx.is_sharded(x):
        routed = _replicated(route, 8, xt, p["router"])
    else:
        routed = route(xt, p["router"])
    xe, gate, dest, rank, kept, aux_loss, util, dropped = routed

    # the expert dim on 'model' (EP), the capacity dim on 'data'; the slot
    # gather across data shards is the AM all-to-all
    xe = dctx.constrain(xe, "model", "data", None)
    h = torch.nn.functional.silu(
        _expert_product(xe, p["wg"]).to(x.dtype).float()).to(x.dtype)
    h = dctx.constrain(h, "model", "data", None)
    h = h * dctx.constrain(_expert_product(xe, p["wi"]).to(x.dtype),
                           "model", "data", None)
    ye = _expert_product(h, p["wo"]).to(x.dtype)             # (E, C, D)
    ye = dctx.constrain(ye, "model", "data", None)

    if dctx.is_sharded(x):
        y = _replicated(_combine, 1, ye, gate, dest, rank, kept)
        y = y.redistribute(xt.device_mesh, xt.placements)
    else:
        y = _combine(ye, gate, dest, rank, kept)
    if "shared" in p:
        y = y + swiglu(p["shared"], xt)
    # the residual stream may hand the gradient back split along the
    # sequence (seq_shard_acts): taken at y's own placements, its flatten
    # to tokens in the backward needs no strided shard
    y = dctx.grad_as_input(y.reshape(b, s, d))
    return y, {"aux_loss": aux_loss, "expert_util": util,
               "dropped_frac": dropped}
