"""Inference steps: prefill, greedy decode and the encoder's encode.

The port of the reference's ``repro/serve/steps.py``.  The caches are
updated in place (the reference donates them).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import context as dctx
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    def prefill_step(params, tokens):
        """tokens: (B, S) -> (logits of the last position, caches)."""
        b, _ = tokens.shape
        mesh = tokens.device_mesh if dctx.is_sharded(tokens) else None
        caches = lm.make_caches(cfg, b, cache_len, device=tokens.device,
                                mesh=mesh)
        logits, caches, _ = lm.forward(
            params, cfg, {"tokens": tokens}, caches=caches, cache_index=0)
        return logits[:, -1, :], caches
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, caches, tokens, cache_index: int):
        """tokens: (B, 1) -> (next tokens (B, 1) int32, caches)."""
        logits, caches, _ = lm.forward(
            params, cfg, {"tokens": tokens}, caches=caches,
            cache_index=cache_index)
        # on a mesh the vocab is made whole first: DTensor's argmax over a
        # split dim reads its shards' offsets back from a tensor, which a
        # fake tensor (the dry run) cannot give
        last = dctx.batch_only(logits[:, -1, :])
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt[:, None], caches
    return decode_step


def encode_step(cfg: ArchConfig):
    """Encoder-only archs (hubert): a prefill-shaped full encode."""
    def step(params, frames):
        """frames: (B, S, 512) -> logits (B, S, vocab)."""
        logits, _, _ = lm.forward(params, cfg, {"frames": frames})
        return logits
    return step
