"""Int8 gradient compression with error feedback: the port of
``quantize``, ``dequantize`` and ``compress_tree`` from the reference's
``repro/train/compress.py``.

Per-tensor symmetric quantization: g ~= scale * int8.  The quantization
error is fed back into the next step's gradient (error feedback keeps the
compression unbiased over time).  The reference's ``psum_compressed``, the
all-reduce of the int8 payloads, needs a collective and waits for the
port's ``distributed/`` slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch

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
