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

import functools
import math

import torch

from repro_torch.distributed import context as dctx
from repro_torch.models import layers as L
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


def _latent(dkv, pos, *, kv_lora, theta):
    """The down-projection (B, S, kv_lora + rope) split into the latent
    c_kv and the shared key, rotated at ``pos``."""
    b, s, _ = dkv.shape
    ckv, kr = dkv[..., :kv_lora], dkv[..., kv_lora:]
    kr = apply_rope(kr[:, :, None, :], pos.expand(b, s), theta)[:, :, 0, :]
    return ckv, kr


def _scores(q, ckv_all, kr_all, wukv, pos, *, cfg, theta, skip, dtype):
    """The heads of ``q`` (B, S, H·(nope + rope)) against the latent cache
    re-expanded through ``wukv`` (kv_lora, H·(nope + v)): (B, S, H·v) in
    ``dtype``.  ``H`` is what the tensors hold (a rank's own heads on a
    mesh); with ``skip`` query block i reads K[: (i+1)·Q_CHUNK]."""
    nd, rd, vd = cfg.nope_dim, cfg.rope_dim, cfg.v_dim
    b, s, _ = q.shape
    h = q.shape[-1] // (nd + rd)
    q = q.reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, pos.expand(b, s), theta)
    skv = ckv_all.shape[1]

    # expand latent to per-head keys/values (recomputed from the compressed
    # cache — the MLA trade: extra matmul for 8-16x less cache memory)
    ukv = _mm(ckv_all, wukv).reshape(b, skv, h, nd + vd)
    k_nope, v = ukv[..., :nd], ukv[..., nd:]

    if skip:
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
    return o.reshape(b, s, h * vd).to(dtype)


def mla_attention(p, x, *, n_heads, cfg, theta, cache=None,
                  cache_index=None, causal_skip=False):
    """Returns (y, cache); cache = {ckv: (B,S,kv_lora), kr: (B,S,rope)},
    updated in place (the reference donates it) and returned.  As XLA's
    ``dynamic_update_slice``, the write offset is clamped so that the
    update fits, while positions use the offset as given.  The mask is
    causal over absolute positions on every path.

    On a mesh the query heads split over ``model`` where they divide it
    (``wq`` column-parallel, ``wukv`` split by head), the latent and the
    shared key are whole on each rank (``wdkv`` gathered), the latent
    cache is written where each rank holds its sequence slice, and the
    re-expansion and the scores run under ``local_map`` on each rank's
    batch rows and heads, the cache regathered along its sequence."""
    b, s, _ = x.shape
    ci = 0 if cache_index is None else int(cache_index)
    pos = ci + torch.arange(s, device=x.device)
    sharded = dctx.is_sharded(x)
    if sharded:
        batch, heads = dctx.batch_axes(), dctx.heads_axis(n_heads)
        # the width whole on each rank: every product's column then sums
        # in one accumulator, as unsharded (a bf16 partial is rounded)
        x = dctx.batch_only(x)
    q = x @ p["wq"]
    dkv = x @ p["wdkv"]
    latent = functools.partial(_latent, pos=pos, kv_lora=cfg.kv_lora,
                               theta=theta)
    if sharded:
        dkv = L._placed(dkv, batch, None, None)
        ckv, kr = L._local(latent, [dkv[1]] * 2, dkv)
    else:
        ckv, kr = latent(dkv)

    if cache is not None:
        at = max(0, min(ci, cache["ckv"].shape[1] - s))
        for name, t in (("ckv", ckv), ("kr", kr)):
            dctx.write_slice(cache[name], t.to(cache[name].dtype), 1, at)
        ckv_all, kr_all = cache["ckv"], cache["kr"]
    else:
        ckv_all, kr_all = ckv, kr

    scores = functools.partial(
        _scores, pos=pos, cfg=cfg, theta=theta, dtype=x.dtype,
        skip=causal_skip and cache is None and s % Q_CHUNK == 0
        and s > Q_CHUNK)
    if sharded:
        o = L._local(
            scores, [dctx.fitted_placements((b, s, n_heads * cfg.v_dim),
                                            batch, None, heads)],
            L._placed(q, batch, None, heads),
            L._placed(ckv_all, batch, None, None),
            L._placed(kr_all, batch, None, None),
            L._placed(p["wukv"], None, heads))
    else:
        o = scores(q, ckv_all, kr_all, p["wukv"])
    return L._row_parallel(o, p["wo"]), cache


def make_mla_cache(b, s, cfg, dtype=torch.bfloat16, device="cuda"):
    return {"ckv": torch.zeros((b, s, cfg.kv_lora), dtype=dtype,
                               device=device),
            "kr": torch.zeros((b, s, cfg.rope_dim), dtype=dtype,
                              device=device)}
