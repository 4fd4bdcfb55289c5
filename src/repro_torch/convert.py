"""Carry state and operands across from the reference as numpy arrays.

The port imports nothing of the JAX package, so the two meet in numpy: a
test turns the reference's ``MachineState`` into ``{field: np.asarray(leaf)}``
and hands it to :func:`state_from_numpy`, which puts the *same* state on
the port's device; :func:`state_to_numpy` goes the other way.
:func:`params_from_numpy` does the same for a model's parameters and
:func:`params_to_numpy` goes back; :func:`adamw_from_numpy` and
:func:`adamw_to_numpy` carry the AdamW state (moments, f32 master weights
and count) in the reference's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.batch import BatchedWorkloads
from repro_torch.core.machine import MachineState
from repro_torch.models.lm import LM, layer_groups
from repro_torch.sparse.formats import BCSR
from repro_torch.train.optimizer import AdamWState


def state_from_numpy(leaves: dict, device="cuda") -> MachineState:
    """``{field: ndarray}`` (every :class:`MachineState` field) -> a
    :class:`MachineState` of tensors on ``device``, dtypes kept."""
    missing = set(MachineState._fields) - set(leaves)
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    return MachineState(**{
        k: torch.as_tensor(np.array(leaves[k]), device=device)
        for k in MachineState._fields})


def state_to_numpy(st: MachineState) -> dict:
    """A :class:`MachineState` -> ``{field: ndarray}`` on the host, as
    copies: the next engine call updates ``pend``, ``swq`` and ``mem_val``
    in place, and on the CPU a bare ``.numpy()`` would share their
    memory."""
    return {k: getattr(st, k).to("cpu", copy=True).numpy()
            for k in MachineState._fields}


def batch_from_numpy(fields: dict) -> BatchedWorkloads:
    """The reference's ``BatchedWorkloads`` arrays (``prog``,
    ``static_ams``, ``amq_len``, ``mem_val``, ``mem_meta`` and optionally
    ``modes`` / ``geoms``) -> the port's :class:`BatchedWorkloads`."""
    def arr(k):
        v = fields.get(k)
        return None if v is None else np.asarray(v, np.int32)
    return BatchedWorkloads(
        prog=arr("prog"), static_ams=arr("static_ams"),
        amq_len=arr("amq_len"), mem_val=arr("mem_val"),
        mem_meta=arr("mem_meta"), modes=arr("modes"), geoms=arr("geoms"))


def bcsr_from_numpy(indptr, indices, blocks, n_blocks, shape, block,
                    device="cuda") -> BCSR:
    """Reference BCSR operands (as numpy) -> the port's :class:`BCSR` on
    ``device``.  Float blocks keep their dtype (bf16 arrives as f32 numpy
    and is cast by the caller)."""
    return BCSR(
        indptr=torch.as_tensor(np.array(indptr, np.int32), device=device),
        indices=torch.as_tensor(np.array(indices, np.int32), device=device),
        blocks=torch.as_tensor(np.array(blocks), device=device),
        n_blocks=int(n_blocks), shape=tuple(shape), block=tuple(block))


def tree_from_numpy(tree: dict, cfg, device="cuda") -> dict:
    """A tree in the reference's layout (numpy, a leading layer axis under
    each stacked group of :func:`repro_torch.models.lm.layer_groups`:
    ``blocks``, ``mlstm``, ``slstm`` or ``mamba``) -> the port's nested
    dict (each group a list of one dict per layer; ``shared_attn``,
    ``frontend`` and ``head`` stay whole) of tensors on ``device``,
    dtypes kept.  A leaf may also be a tensor."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.to(device, copy=True)
        return torch.as_tensor(np.array(v), device=device)

    def leaves(t, i=None):
        return {k: leaves(v, i) if isinstance(v, dict) else
                leaf(v if i is None else v[i]) for k, v in t.items()}
    groups = layer_groups(cfg)
    if not set(groups) <= set(tree):
        raise ValueError(f"{cfg.name}: the tree lacks the layer groups "
                         f"{sorted(set(groups) - set(tree))}")
    return {k: [leaves(v, i) for i in range(groups[k])] if k in groups
            else leaves(v) for k, v in tree.items()}


def tree_to_numpy(tree: dict) -> dict:
    """The inverse of :func:`tree_from_numpy`: host numpy copies with each
    group's layers stacked (a bf16 leaf comes back as f32, which holds it
    exactly: numpy has no bf16)."""
    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return np.stack(ts)
    return {k: stack([host(b) for b in v]) if isinstance(v, list)
            else host(v) for k, v in tree.items()}


def params_from_numpy(tree: dict, cfg, device="cuda") -> LM:
    """The reference's parameter pytree of any family, as numpy with a
    leading layer axis under each stacked group -> the port's
    :class:`repro_torch.models.lm.LM` on ``device``, dtypes kept."""
    return LM(tree_from_numpy(tree, cfg, device))


def params_to_numpy(params: LM) -> dict:
    """The port's :class:`LM` -> the reference's parameter pytree as
    numpy (:func:`tree_to_numpy`)."""
    return tree_to_numpy(params.tree())


def adamw_from_numpy(state: dict, cfg, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` as ``{"m", "v", "master": pytree,
    "count": int}`` of numpy -> the port's :class:`AdamWState` on
    ``device``."""
    return AdamWState(
        *(tree_from_numpy(state[k], cfg, device) for k in
          ("m", "v", "master")),
        count=torch.tensor(int(state["count"]), dtype=torch.int32,
                           device=device))


def adamw_to_numpy(state: AdamWState) -> dict:
    """The inverse of :func:`adamw_from_numpy`."""
    return dict(m=tree_to_numpy(state.m), v=tree_to_numpy(state.v),
                master=tree_to_numpy(state.master), count=int(state.count))
