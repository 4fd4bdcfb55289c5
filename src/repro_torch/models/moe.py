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
einsum returns that dtype.  The reference's sharding constraints are
identity on one device and have no counterpart here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.group_matmul import grouped_expert_matmul
from repro_torch.models.layers import _init, swiglu
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


def moe_apply(p, x, cfg, *, deterministic_capacity: int | None = None):
    """x: (B, S, D) -> (y, aux) with aux = load-balancing stats/loss.

    Static shapes throughout: tokens are bucketized per expert with
    capacity C = ceil(T*k/E * capacity_factor); overflow is re-routed
    (load_steal) or dropped.  The top-k takes the lower expert index on
    ties, as ``jax.lax.top_k`` does (a stable descending sort).
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = gate[:, :k], choice[:, :k]                # (T, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    cap = deterministic_capacity or int(
        math.ceil(t * k / e * cfg.capacity_factor))
    dest = choice.reshape(t * k).to(torch.int32)             # messages
    if cfg.load_steal:
        load = _segment_count(dest, e, torch.int32)
        dest = steal_overflow(dest, load, cap)
        # gates follow the message: a stolen token is weighted by the
        # router's probability for the expert that actually serves it
        gate = torch.gather(probs, -1, dest.reshape(t, k).long())
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    idx, valid, rank, kept = bucketize(dest, e, cap)         # AM buckets

    tok_of_slot = (idx // k).long()                          # (E, C)
    xe = torch.where(valid[..., None], xt[tok_of_slot], 0)   # (E, C, D)
    h = torch.nn.functional.silu(
        grouped_expert_matmul(xe, p["wg"]).to(x.dtype).float()
    ).to(x.dtype)
    h = h * grouped_expert_matmul(xe, p["wi"]).to(x.dtype)
    ye = grouped_expert_matmul(h, p["wo"]).to(x.dtype)       # (E, C, D)

    back = unbucketize(ye, dest, rank, kept)                 # (T*k, D)
    y = (back.reshape(t, k, d) * gate[..., None].to(x.dtype)).sum(1)
    if "shared" in p:
        y = y + swiglu(p["shared"], xt)
    y = y.reshape(b, s, d)

    # Switch-style aux load-balance loss + utilization stats
    me = probs.mean(0)
    ce = _segment_count(dest, e, torch.float32) / (t * k)
    aux_loss = e * torch.sum(me * ce)
    util = (ce > 0).float().mean()
    dropped = 1.0 - kept.float().mean()
    return y, {"aux_loss": aux_loss, "expert_util": util,
               "dropped_frac": dropped}
