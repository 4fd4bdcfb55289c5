"""Int8 gradient compression with error feedback: the port of the
reference's ``repro/train/compress.py``.

Per-tensor symmetric quantization: g ~= scale * int8.  The quantization
error is fed back into the next step's gradient (error feedback keeps the
compression unbiased over time).  :func:`psum_compressed` all-reduces the
dequantized int8 payloads over an axis of a
:class:`repro_torch.launch.mesh.Mesh`, one gradient tree per shard.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh, map_shards, psum
from repro_torch.train.optimizer import tree_map


def quantize(g: torch.Tensor):
    """g -> (int8 payload, f32 scale); rounds half to even, as JAX."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, error):
    """(grads + error) -> (quantized payload, scales, new error feedback),
    each a tree of ``grads``' structure; ``error`` None starts at zero."""
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)
    adjusted = tree_map(lambda g, e: g.float() + e, grads, error)
    qs = tree_map(quantize, adjusted)
    payload = tree_map(lambda a, t: t[0], adjusted, qs)
    scales = tree_map(lambda a, t: t[1], adjusted, qs)
    new_error = tree_map(lambda a, q, s: a - dequantize(q, s), adjusted,
                         payload, scales)
    return payload, scales, new_error


def psum_compressed(grads: list, error: list | None, *, mesh: Mesh,
                    axis: str):
    """All-reduce int8 payloads over ``axis``: ``grads`` and ``error`` are
    lists with one tree per shard (``error`` None, or None entries, start
    at zero), each on its shard's device.  Every shard compresses its own
    ``grads + error`` (:func:`compress_tree`); returns ``(summed,
    new_error)``, per-shard lists: each shard's sum of every shard's
    dequantized payload (a psum in shard order, f32) and each shard's new
    error feedback."""
    if error is None:
        error = [None] * len(grads)
    packs = [compress_tree(g, e) for g, e in zip(grads, error)]
    deq = [tree_map(dequantize, p, sc) for p, sc, _ in packs]
    summed = map_shards(lambda xs: psum(xs, mesh, axis), deq)
    return summed, [e for _, _, e in packs]
