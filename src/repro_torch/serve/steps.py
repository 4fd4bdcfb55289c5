"""Inference steps: prefill and greedy decode.

The port of ``make_prefill_step`` and ``make_decode_step`` from the
reference's ``repro/serve/steps.py``.  The KV caches are updated in place
(the reference donates them).
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    def prefill_step(params, tokens):
        """tokens: (B, S) -> (logits of the last position, caches)."""
        b, _ = tokens.shape
        caches = lm.make_caches(cfg, b, cache_len, device=tokens.device)
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
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], caches
    return decode_step
