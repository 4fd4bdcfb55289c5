"""Carry state and operands across from the reference as numpy arrays.

The port imports nothing of the JAX package, so the two meet in numpy: a
test turns the reference's ``MachineState`` into ``{field: np.asarray(leaf)}``
and hands it to :func:`state_from_numpy`, which puts the *same* state on
the port's device; :func:`state_to_numpy` goes the other way.
:func:`params_from_numpy` does the same for a model's parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.batch import BatchedWorkloads
from repro_torch.core.machine import MachineState
from repro_torch.models.lm import LM
from repro_torch.sparse.formats import BCSR


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
    """A :class:`MachineState` -> ``{field: ndarray}`` on the host."""
    return {k: getattr(st, k).cpu().numpy() for k in MachineState._fields}


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


def params_from_numpy(tree: dict, cfg, device="cuda") -> LM:
    """The reference's parameter pytree of a dense / MoE transformer, as
    numpy with a leading layer axis under ``"blocks"`` -> the port's
    :class:`repro_torch.models.lm.LM` on ``device``, dtypes kept."""
    def leaves(t, i=None):
        return {k: leaves(v, i) if isinstance(v, dict) else
                torch.as_tensor(np.array(v if i is None else v[i]),
                                device=device)
                for k, v in t.items()}
    top = {k: leaves(v) for k, v in tree.items() if k != "blocks"}
    top["blocks"] = [leaves(tree["blocks"], i) for i in range(cfg.n_layers)]
    return LM(top)
