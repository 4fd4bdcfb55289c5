"""Multi-head Latent Attention (DeepSeek-V2): the port of the reference's
``repro/models/mla.py``.

KV is compressed into a ``kv_lora``-dim latent c_kv plus a shared RoPE
key; the decode cache stores only (c_kv, k_rope).  DeepSeek-V2-*Lite*
uses no query compression, which is what the reference implements.
Scores are taken in f32 on every path and masked with -1e30 (not -inf),
and every call re-expands the whole cache through ``wukv``, as in the
reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import _init, _mm, apply_rope

#: the query block of the causal skip (the reference's constant)
Q_CHUNK = 256


def mla_init(gen, d, n_heads, cfg, dtype=torch.bfloat16):
    qd = cfg.nope_dim + cfg.rope_dim
    return {
        "wq": _init(gen, (d, n_heads * qd), dtype=dtype),
        # down-projection: latent c_kv + shared rope key
        "wdkv": _init(gen, (d, cfg.kv_lora + cfg.rope_dim), dtype=dtype),
        # up-projection: per-head nope key + value
        "wukv": _init(gen, (cfg.kv_lora,
                            n_heads * (cfg.nope_dim + cfg.v_dim)),
                      dtype=dtype),
        "wo": _init(gen, (n_heads * cfg.v_dim, d),
                    scale=1.0 / math.sqrt(n_heads * cfg.v_dim), dtype=dtype),
    }


def _mla_scores_block(qn, qr, k_nope, kr, v, qp, skv, nd, rd):
    logits = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", qr.float(), kr.float())
              ) / math.sqrt(nd + rd)
    mask = qp[:, None] >= torch.arange(skv, device=qp.device)[None, :]
    logits = torch.where(mask[None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float())


def mla_attention(p, x, *, n_heads, cfg, theta, cache=None,
                  cache_index=None, causal_skip=False):
    """Returns (y, cache); cache = {ckv: (B,S,kv_lora), kr: (B,S,rope)},
    updated in place (the reference donates it) and returned.  As XLA's
    ``dynamic_update_slice``, the write offset is clamped so that the
    update fits, while positions use the offset as given.  The mask is
    causal over absolute positions on every path."""
    b, s, _ = x.shape
    nd, rd, vd = cfg.nope_dim, cfg.rope_dim, cfg.v_dim
    q = (x @ p["wq"]).reshape(b, s, n_heads, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    dkv = x @ p["wdkv"]
    ckv, kr = dkv[..., :cfg.kv_lora], dkv[..., cfg.kv_lora:]
    ci = 0 if cache_index is None else int(cache_index)
    pos = ci + torch.arange(s, device=x.device)
    q_rope = apply_rope(q_rope, pos.expand(b, s), theta)
    kr = apply_rope(kr[:, :, None, :], pos.expand(b, s), theta)[:, :, 0, :]

    if cache is not None:
        at = max(0, min(ci, cache["ckv"].shape[1] - s))
        cache["ckv"][:, at:at + s] = ckv.to(cache["ckv"].dtype)
        cache["kr"][:, at:at + s] = kr.to(cache["kr"].dtype)
        ckv_all, kr_all = cache["ckv"], cache["kr"]
    else:
        ckv_all, kr_all = ckv, kr
    skv = ckv_all.shape[1]

    # expand latent to per-head keys/values (recomputed from the compressed
    # cache — the MLA trade: extra matmul for 8-16x less cache memory)
    ukv = _mm(ckv_all, p["wukv"]).reshape(b, skv, n_heads, nd + vd)
    k_nope, v = ukv[..., :nd], ukv[..., nd:]

    if causal_skip and cache is None and s % Q_CHUNK == 0 and s > Q_CHUNK:
        # block-causal skip: query block i attends to K[: (i+1)·Q_CHUNK]
        outs = []
        for i in range(s // Q_CHUNK):
            lo, hi = i * Q_CHUNK, (i + 1) * Q_CHUNK
            outs.append(_mla_scores_block(
                q_nope[:, lo:hi], q_rope[:, lo:hi], k_nope[:, :hi],
                kr_all[:, :hi], v[:, :hi], pos[lo:hi], hi, nd, rd))
        o = torch.cat(outs, dim=1)
    else:
        o = _mla_scores_block(q_nope, q_rope, k_nope, kr_all, v, pos, skv,
                              nd, rd)
    y = _mm(o.reshape(b, s, n_heads * vd).to(x.dtype), p["wo"])
    return y, cache


def make_mla_cache(b, s, cfg, dtype=torch.bfloat16, device="cuda"):
    return {"ckv": torch.zeros((b, s, cfg.kv_lora), dtype=dtype,
                               device=device),
            "kr": torch.zeros((b, s, cfg.rope_dim), dtype=dtype,
                              device=device)}
