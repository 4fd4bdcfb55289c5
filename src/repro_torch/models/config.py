"""Architecture configuration schema for the assigned model pool.

One ``ArchConfig`` fully determines parameter shapes, the block program
(dense / MoE / MLA / Mamba-2 hybrid / xLSTM / encoder-only), and the
modality frontend stub.  ``reduced()`` produces the CPU-smoke-test variant
of the same family (same code paths, tiny dims).

A copy of the reference's ``repro/models/config.py`` (plain dataclasses,
no JAX); ``tests/test_torch_models.py`` holds every config and its
``reduced()`` equal to the reference's, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden dim
    n_shared: int = 0          # always-on shared experts (DeepSeek style)
    d_shared: int = 0
    capacity_factor: float = 1.25
    # Nexus Machine integration: opportunistic overflow re-routing (§3.1.3)
    load_steal: bool = True


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_heads: int = 8           # SSD heads
    chunk: int = 64
    attn_every: int = 6        # hybrid: shared attention block period (zamba2)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    rope_theta: float = 1e6
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    xlstm: bool = False
    encoder_only: bool = False
    frontend: Literal["none", "audio", "vision"] = "none"
    n_patches: int = 2880      # vlm anyres tiles (5 tiles x 576)
    d_frontend: int = 1024     # stub embedding width
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- distribution / memory knobs (perf-loop levers) -------------------
    remat: Literal["none", "full", "dots"] = "none"
    seq_shard_acts: bool = False       # sequence parallelism between blocks
    unroll_layers: bool = False        # python loop instead of lax.scan
                                       # (exact cost_analysis; see roofline)
    block_causal: bool = False         # causal-skip attention (train/prefill:
                                       # never compute masked S²/2 — §Perf)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embed
        if not self.tie_embeddings and not self.encoder_only:
            n += d * v
        per = 0
        if self.xlstm:
            # mLSTM block: qkv + gates + out + ffn-less (d_ff = 0)
            per = d * (3 * 2 * d) + 2 * d + (2 * d) * d
        elif self.ssm is not None:
            di = self.ssm.expand * d
            per_m = d * 2 * di + di * d + di * (2 * self.ssm.d_state)
            per = per_m
        else:
            hq = self.n_heads * self.hd
            hk = self.n_kv * self.hd
            if self.mla:
                m = self.mla
                attn = (d * self.n_heads * (m.nope_dim + m.rope_dim)
                        + d * (m.kv_lora + m.rope_dim)
                        + m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim)
                        + self.n_heads * m.v_dim * d)
            else:
                attn = d * hq + 2 * d * hk + hq * d
            if self.moe:
                e = self.moe
                ffn = (e.n_experts * 3 * d * e.d_expert + d * e.n_experts
                       + e.n_shared * 3 * d * max(e.d_shared, 1))
            else:
                ffn = 3 * d * self.d_ff
            per = attn + ffn
        n += self.n_layers * per
        if self.ssm is not None and self.ssm.attn_every:
            hq = self.n_heads * self.hd
            n += d * hq + 2 * d * self.n_kv * self.hd + hq * d  # shared block
        return n

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        full = self.param_count()
        moe_all = self.n_layers * e.n_experts * 3 * self.d_model * e.d_expert
        moe_act = self.n_layers * e.top_k * 3 * self.d_model * e.d_expert
        return full - moe_all + moe_act

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (same code paths)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if self.ssm is None else 4),
            d_model=128,
            n_heads=4,
            n_kv=2 if self.n_kv < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32,
            n_patches=8,
            d_frontend=64,
            moe=None if self.moe is None else MoECfg(
                n_experts=4, top_k=min(self.moe.top_k, 2), d_expert=64,
                n_shared=min(self.moe.n_shared, 1), d_shared=64,
                load_steal=self.moe.load_steal),
            mla=None if self.mla is None else MLACfg(
                kv_lora=32, rope_dim=16, nope_dim=32, v_dim=32),
            ssm=None if self.ssm is None else SSMCfg(
                d_state=16, d_conv=4, expand=2, n_heads=2, chunk=8,
                attn_every=2),
        )
