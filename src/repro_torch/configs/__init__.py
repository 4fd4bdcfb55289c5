"""Assigned architecture pool: one config per arch + shape definitions.

Use ``get_arch(name)`` / ``ARCHS`` and ``SHAPES`` / ``cells()``.

A copy of the reference's ``repro/configs`` (data only) on the port's
``repro_torch.models.config`` dataclasses.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "mistral_large_123b", "minitron_8b", "minitron_4b", "stablelm_3b",
    "zamba2_1p2b", "xlstm_350m", "hubert_xlarge", "phi35_moe_42b",
    "deepseek_v2_lite_16b", "llava_next_mistral_7b",
]

# canonical external ids (the --arch flag accepts both forms)
ALIASES = {
    "mistral-large-123b": "mistral_large_123b",
    "minitron-8b": "minitron_8b",
    "minitron-4b": "minitron_4b",
    "stablelm-3b": "stablelm_3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "xlstm-350m": "xlstm_350m",
    "hubert-xlarge": "hubert_xlarge",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

# (seq_len, global_batch, kind); kind: train | prefill | decode | long
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "long"),
}


def get_arch(name: str):
    mod_name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def runnable(arch_cfg, shape_id: str) -> tuple[bool, str]:
    """Cell applicability per DESIGN.md §4 (skips are documented, not bugs)."""
    kind = SHAPES[shape_id][2]
    if arch_cfg.encoder_only and kind in ("decode", "long"):
        return False, "encoder-only: no autoregressive step exists"
    if kind == "long" and arch_cfg.ssm is None and not arch_cfg.xlstm:
        return False, ("pure full-attention arch: 524k dense KV cache is the "
                       "quadratic/full-cache case the assignment skips")
    return True, ""


def cells():
    """All 40 (arch x shape) cells with runnability verdicts."""
    out = []
    for a in ARCH_IDS:
        cfg = get_arch(a)
        for s in SHAPES:
            ok, why = runnable(cfg, s)
            out.append((a, s, ok, why))
    return out
