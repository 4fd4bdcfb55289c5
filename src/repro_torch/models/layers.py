"""Core transformer layers (functional, dict-like params).

The port of the reference's ``repro/models/layers.py`` for the dense and
MoE text models: RMSNorm, rotary embeddings, grouped-query attention with
and without a KV cache, SwiGLU, embedding and unembedding.  Conventions
are the reference's:

  * activations in the parameters' dtype (bf16 at full width),
    reductions and softmax in f32;
  * params are dict-like (``p["wq"]``); init fns mirror apply fns;
  * KV caches are laid out (B, n_kv, S, hd).

These products are plain XLA matmuls in the reference, so they are plain
``torch.matmul`` here.  Mixed dtypes promote as in JAX (a bf16 cache read
times f32 weights is an f32 product).
"""
from __future__ import annotations

import math

import torch


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.bfloat16):
    """Normal(0, scale^2) drawn in f32 on ``gen``'s device, then cast;
    ``scale`` defaults to 1/sqrt(shape[0]) as in the reference."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion (bf16 @ f32 -> f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ------------------------------------------------------------------ norms --
def rmsnorm_init(d, device="cuda"):
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * p["g"]).to(x.dtype)


# ------------------------------------------------------------------- rope --
def rope_freqs(hd: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, pos, theta=1e6):
    """x: (..., S, H, hd); pos: (..., S) integer positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    ang = pos[..., None].float() * freqs                  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention --
def attn_init(gen, d, n_heads, n_kv, hd, dtype=torch.bfloat16):
    return {
        "wq": _init(gen, (d, n_heads * hd), dtype=dtype),
        "wk": _init(gen, (d, n_kv * hd), dtype=dtype),
        "wv": _init(gen, (d, n_kv * hd), dtype=dtype),
        "wo": _init(gen, (n_heads * hd, d),
                    scale=1.0 / math.sqrt(n_heads * hd), dtype=dtype),
    }


def _sdpa_block(qg, k, v, qp, *, causal, kv_len):
    """One query block: qg (B,KV,G,C,hd) vs full K/V (B,KV,Skv,hd)."""
    hd = qg.shape[-1]
    skv = k.shape[2]
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    cols = torch.arange(skv, device=k.device)
    if causal:
        mask = qp[:, None] >= cols[None, :]
        logits = torch.where(mask[None, None, None], logits, -1e30)
    if kv_len is not None:
        mask = cols[None, :] < torch.as_tensor(kv_len,
                                               device=k.device).reshape(-1, 1)
        logits = torch.where(mask[:, None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bksd->bkgqd", w, v.float())


def _sdpa(q, k, v, *, causal: bool, q_pos=None, kv_len=None,
          q_chunk: int | None = 256, causal_skip: bool = False):
    """q: (B,H,Sq,hd), k/v: (B,KV,Skv,hd) — grouped-query attention.

    Long query sequences are processed in query blocks, each computing its
    complete softmax row against K (the reference's memory-frugal
    dataflow); with ``causal_skip`` block i only reads K[: (i+1)·q_chunk].
    kv_len: live cache length (decode masking).
    """
    b, h, sq, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, hd)
    qp = q_pos if q_pos is not None else torch.arange(sq, device=q.device)
    if q_chunk is None or sq <= q_chunk or sq % q_chunk != 0:
        out = _sdpa_block(qg, k, v, qp, causal=causal, kv_len=kv_len)
        return out.reshape(b, h, sq, hd).to(v.dtype)
    skip = causal_skip and causal and kv_len is None and q_pos is None
    outs = []
    for i in range(sq // q_chunk):
        sl = slice(i * q_chunk, (i + 1) * q_chunk)
        ki, vi = (k[:, :, :sl.stop], v[:, :, :sl.stop]) if skip else (k, v)
        outs.append(_sdpa_block(qg[:, :, :, sl], ki, vi, qp[sl],
                                causal=causal, kv_len=kv_len))
    out = torch.cat(outs, dim=3)
    return out.reshape(b, h, sq, hd).to(v.dtype)


def attention(p, x, *, n_heads, n_kv, hd, theta, causal=True, pos=None,
              cache=None, cache_index=None, causal_skip=False):
    """Returns (y, cache).

    cache: dict(k=(B,KV,S,hd), v=...) or None; cache_index: int write
    offset for decode / prefill-append.  The cache is updated in place
    (the reference donates it) and returned.  As XLA's
    ``dynamic_update_slice``, the write offset is clamped so that the
    update fits, while positions and masks use the offset as given.
    """
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, n_kv, hd)
    v = (x @ p["wv"]).reshape(b, s, n_kv, hd)
    if pos is None:
        base = 0 if cache_index is None else int(cache_index)
        pos = (base + torch.arange(s, device=x.device)).expand(b, s)
    q = apply_rope(q, pos, theta).transpose(1, 2)          # (B,H,S,hd)
    k = apply_rope(k, pos, theta).transpose(1, 2)          # (B,KV,S,hd)
    v = v.transpose(1, 2)
    if cache is not None:
        ci = 0 if cache_index is None else int(cache_index)
        at = max(0, min(ci, cache["k"].shape[2] - s))
        cache["k"][:, :, at:at + s] = k.to(cache["k"].dtype)
        cache["v"][:, :, at:at + s] = v.to(cache["v"].dtype)
        # causal over absolute positions (covers prefill-append and decode)
        o = _sdpa(q, cache["k"], cache["v"], causal=True,
                  q_pos=ci + torch.arange(s, device=x.device),
                  kv_len=ci + s)
    else:
        o = _sdpa(q, k, v, causal=causal, causal_skip=causal_skip)
    y = _mm(o.transpose(1, 2).reshape(b, s, n_heads * hd), p["wo"])
    return y, cache


def make_cache(b, n_kv, s, hd, dtype=torch.bfloat16, device="cuda"):
    return {"k": torch.zeros((b, n_kv, s, hd), dtype=dtype, device=device),
            "v": torch.zeros((b, n_kv, s, hd), dtype=dtype, device=device)}


# ------------------------------------------------------------------- mlps --
def swiglu_init(gen, d, f, dtype=torch.bfloat16):
    return {"wi": _init(gen, (d, f), dtype=dtype),
            "wg": _init(gen, (d, f), dtype=dtype),
            "wo": _init(gen, (f, d), scale=1.0 / math.sqrt(f), dtype=dtype)}


def swiglu(p, x):
    h = torch.nn.functional.silu((x @ p["wg"]).float()).to(x.dtype)
    return (h * (x @ p["wi"])) @ p["wo"]


# -------------------------------------------------------------- embedding --
def embed_init(gen, v, d, dtype=torch.bfloat16):
    return {"e": _init(gen, (v, d), scale=1.0, dtype=dtype)}


def embed(p, tokens):
    return p["e"][tokens.long()]


def unembed_init(gen, d, v, dtype=torch.bfloat16):
    return {"w": _init(gen, (d, v), dtype=dtype)}


def unembed(p, x):
    return (x @ p["w"]).float()
