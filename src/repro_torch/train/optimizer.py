"""AdamW with f32 master weights: the port of the reference's
``repro/train/optimizer.py``, as functions on nested trees of tensors
(dicts and lists, such as :meth:`repro_torch.models.lm.LM.tree`).

The arithmetic is the reference's: the global-norm clip, the bias
correction and ``w - lr * (step + wd * w)`` on the f32 master copy, which
is then rounded to each parameter's dtype.  ``torch.optim.AdamW`` updates
the (bf16) parameters themselves with no master copy, so it is not the
same function.  Where the reference donates its buffers, the update here
is in place: ``m``, ``v``, ``master`` and the parameters are overwritten,
and the returned state holds the same tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    m: dict
    v: dict
    master: dict     # f32 master copy of the (bf16) params
    count: torch.Tensor


def tree_leaves(tree) -> list:
    """Leaves in the reference's flatten order: dict keys sorted, lists
    and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *ts) for ts in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    """Zero moments, an f32 copy of ``params`` and a zero count, on the
    parameters' device (the moments and the copy of a ``DTensor``
    parameter are ``DTensor``s placed as it is)."""
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=torch.float32, memory_format=torch.contiguous_format)
    dev = tree_leaves(params)[0].device
    return AdamWState(
        m=tree_map(zeros, params), v=tree_map(zeros, params),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf, leaf by leaf in
    :func:`tree_leaves` order (a 0-dim tensor; no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step.  Returns ``(params, state, gnorm)``: the same
    parameter and state tensors, updated in place, and the gradients'
    global norm before clipping."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    c1 = 1 - b1 ** count.float()
    c2 = 1 - b2 ** count.float()
    for g, m, v, w, p in zip(*map(tree_leaves, (grads, state.m, state.v,
                                                state.master, params))):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        w.sub_(lr * (step + weight_decay * w))
        p.copy_(w)
    return params, AdamWState(state.m, state.v, state.master, count), gnorm
