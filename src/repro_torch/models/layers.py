"""Core transformer layers (functional, dict-like params).

The port of the reference's ``repro/models/layers.py``: RMSNorm, rotary
embeddings, grouped-query attention with and without a KV cache (causal,
or not for the encoder), SwiGLU, the GELU MLP, embedding, unembedding and
the training loss (``cross_entropy``).  Conventions are the reference's:

  * activations in the parameters' dtype (bf16 at full width),
    reductions and softmax in f32;
  * params are dict-like (``p["wq"]``); init fns mirror apply fns;
  * KV caches are laid out (B, n_kv, S, hd).

These products are plain XLA matmuls in the reference, so they are plain
``torch.matmul`` here.  Mixed dtypes promote as in JAX (a bf16 cache read
times f32 weights is an f32 product).

On a mesh (``DTensor`` activations under
``repro_torch.distributed.context.use_mesh``) the input of attention and
of each MLP is made whole along everything but the batch (a residual
stream split along its width or its sequence: the column-parallel
products then sum each output in one accumulator, and no view flattens
a split sequence, which some torch versions refuse), the heads split over
``model``, attention's core and the embedding lookup run on each rank's
own shard under ``local_map``, the cache is written where each rank holds
its sequence slice, and the row-parallel products sum their partials in
f32.  Without a mesh every function is the plain one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import context as dctx


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
        # a host int compares as a scalar: no tensor is made of it (a fake
        # run would make such a constant for real on the device)
        lim = kv_len.to(k.device).reshape(-1, 1) if isinstance(
            kv_len, torch.Tensor) else kv_len
        mask = cols[None, :] < lim
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


def _split_heads(t, n: int, hd: int, n_kv: int):
    """(B, S, n*hd) -> (B, S, n, hd).  On a mesh the projection's output
    dim is constrained first: split over ``model`` where the ``n_kv`` KV
    heads (and so the query heads) divide it, else whole (a split inside
    a head, or a query group, has no view rule)."""
    b, s, _ = t.shape
    if dctx.is_sharded(t):
        t = dctx.constrain(t, dctx.batch_axes(), None,
                           dctx.heads_axis(n_kv))
    return t.reshape(b, s, n, hd)


def _row_parallel(x, w):
    """``x @ w`` (JAX's promotion) for a row-parallel weight (``wo``,
    split over ``model`` along its input).  On a mesh each rank's partial
    product is f32 and the partials are summed before the one rounding to
    the activations' dtype, as a single product's f32 accumulator is: a
    bf16 partial rounded and then summed would move the residual stream,
    and a MoE router reading it, a bf16 step off the unsharded run."""
    if not dctx.is_sharded(x):
        return _mm(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return dctx.batch_only(x.float() @ w.float()).to(dt)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _core(q, k, v, *, cache_layout: bool, **kw):
    """Attention on q (B, S, H, hd) and k / v (B, S, KV, hd), or in the
    cache's (B, KV, S, hd) with ``cache_layout``: :func:`_sdpa` in its
    head-major layout, the output back as a contiguous (B, S, H, hd)."""
    q = q.transpose(1, 2)
    if not cache_layout:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    return _sdpa(q, k, v, **kw).transpose(1, 2).contiguous()


def _local(fn, outs: list, *args):
    """``fn`` on each rank's own shards, under ``local_map``: ``args`` are
    ``(DTensor, placements)`` pairs, each input redistributed to its
    placements and handed to ``fn`` as its local tensor; ``outs`` holds
    one placements tuple per output of ``fn`` (one output is returned as
    it is, several as a tuple).  An input that is whole over a mesh dim
    that splits the first output gets a partial-sum gradient there (each
    rank's backward sees its own outputs only), and every gradient handed
    back is contiguous (a ``DTensor`` that views a transposed gradient
    fails on some torch versions).  So every output must be whole over
    the same mesh dims as the first."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    whole = [q == Replicate() for q in outs[0]]
    if any([q == Replicate() for q in o] != whole for o in outs[1:]):
        raise ValueError(f"outputs whole over different mesh dims: {outs}")
    places = tuple(tuple(p) for _, p in args)
    grads = tuple(tuple(Partial() if q == Replicate() and o != Replicate()
                        else q for q, o in zip(p, outs[0]))
                  for p in places)

    def local(*ts):
        return fn(*(_ContiguousGrad.apply(t) for t in ts))

    out = (list(outs[0]) if len(outs) == 1 else
           tuple(list(o) for o in outs))
    return local_map(local, out_placements=out, in_placements=places,
                     in_grad_placements=grads,
                     device_mesh=args[0][0].device_mesh,
                     redistribute_inputs=True)(*(t for t, _ in args))


def _placed(t, *axes):
    """``(t, its placements on the active mesh for axes)``: an argument of
    :func:`_local` (:func:`dctx.fitted_placements`)."""
    return t, dctx.fitted_placements(t.shape, *axes)


def _attend(q, k, v, n_kv: int, **kw):
    """:func:`_core`.  On a mesh it runs under ``local_map`` on each
    rank's batch rows and heads (split over ``model`` where the ``n_kv``
    KV heads divide it): every softmax row is whole on its rank, and a
    cache split along its sequence is regathered by head for the call.
    The layouts change only inside it, on each rank's own tensors."""
    if not dctx.is_sharded(q):
        return _core(q, k, v, **kw)
    kv_heads = 1 if kw["cache_layout"] else 2
    heads = dctx.heads_axis(n_kv)
    q_place = dctx.fitted_placements(
        q.shape, dctx.batch_axes(), None, heads, None)
    kv_axes = [dctx.batch_axes(), None, None, None]
    kv_axes[kv_heads] = heads
    kv_place = dctx.fitted_placements(k.shape, *kv_axes)
    return _local(lambda q, k, v: _core(q, k, v, **kw), [q_place],
                  (q, q_place), (k, kv_place), (v, kv_place))


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
    x = dctx.batch_only(x)
    q = _split_heads(x @ p["wq"], n_heads, hd, n_kv)
    k = _split_heads(x @ p["wk"], n_kv, hd, n_kv)
    v = _split_heads(x @ p["wv"], n_kv, hd, n_kv)
    if pos is None:
        base = 0 if cache_index is None else int(cache_index)
        pos = (base + torch.arange(s, device=x.device)).expand(b, s)
    q = apply_rope(q, pos, theta)                          # (B,S,H,hd)
    k = apply_rope(k, pos, theta)                          # (B,S,KV,hd)
    if cache is not None:
        ci = 0 if cache_index is None else int(cache_index)
        at = max(0, min(ci, cache["k"].shape[2] - s))
        for name, t in (("k", k), ("v", v)):
            dctx.write_slice(cache[name],
                             t.transpose(1, 2).to(cache[name].dtype), 2, at)
        # causal over absolute positions (covers prefill-append and decode)
        o = _attend(q, cache["k"], cache["v"], n_kv, cache_layout=True,
                    causal=True, q_pos=ci + torch.arange(s, device=x.device),
                    kv_len=ci + s)
    else:
        o = _attend(q, k, v, n_kv, cache_layout=False, causal=causal,
                    causal_skip=causal_skip)
    o = o.reshape(b, s, n_heads * hd)
    if dctx.heads_axis(n_heads) is None:
        o = dctx.grad_as_input(o)
    y = _row_parallel(o, p["wo"])
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
    x = dctx.batch_only(x)
    h = torch.nn.functional.silu((x @ p["wg"]).float()).to(x.dtype)
    return _row_parallel(h * (x @ p["wi"]), p["wo"])


def gelu_mlp_init(gen, d, f, dtype=torch.bfloat16):
    return {"wi": _init(gen, (d, f), dtype=dtype),
            "wo": _init(gen, (f, d), scale=1.0 / math.sqrt(f), dtype=dtype)}


def gelu_mlp(p, x):
    """GELU in its tanh form, ``jax.nn.gelu``'s default."""
    x = dctx.batch_only(x)
    h = torch.nn.functional.gelu((x @ p["wi"]).float(), approximate="tanh")
    return _row_parallel(h.to(x.dtype), p["wo"])


# -------------------------------------------------------------- embedding --
def embed_init(gen, v, d, dtype=torch.bfloat16):
    return {"e": _init(gen, (v, d), scale=1.0, dtype=dtype)}


def embed(p, tokens):
    """``e[tokens]``.  On a mesh the lookup runs under ``local_map`` on
    each rank's token rows and its slice of the model width (the vocab
    whole): a rank's gradient of ``e`` then sums its own tokens only, a
    partial sum over the batch axes (the lookup's backward has no DTensor
    rule on some torch versions)."""
    e = p["e"]
    if not dctx.is_sharded(e):
        return e[tokens.long()]
    from torch.distributed.tensor import Replicate, Shard
    e_place = tuple(q if q == Shard(1) else Replicate() for q in e.placements)
    t_place = tuple(tokens.placements)
    out = tuple(Shard(0) if t == Shard(0) else Shard(2) if q == Shard(1)
                else Replicate() for t, q in zip(t_place, e_place))
    return _local(lambda e, t: e[t.long()], [out], (e, e_place),
                  (tokens, t_place))


def unembed_init(gen, d, v, dtype=torch.bfloat16):
    return {"w": _init(gen, (d, v), dtype=dtype)}


def unembed(p, x):
    return (x @ p["w"]).float()


def _token_loss(logits, labels):
    """Each token's ``logsumexp(logits) - logits[label]``."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy of ``logits`` (..., V) against integer
    ``labels`` (...); with ``mask`` (...), the mask-weighted mean over at
    least one token, as the reference.  On a mesh the logits are gathered
    along the vocab (their gather has no sharded rule), the batch kept
    split, and each rank takes its own tokens' losses under
    ``local_map``: DTensor's rules for the loss's backward would
    otherwise make the logits' gradient whole over the batch on every
    rank (the dry run counts 1.07 TB a rank for Minitron-8B's
    ``train_4k`` on the 16 x 16 mesh)."""
    logits = dctx.batch_only(logits)
    if dctx.is_sharded(logits):
        place = tuple(logits.placements)
        loss = _local(_token_loss, [place], (logits, place),
                      _placed(labels, dctx.batch_axes(),
                              *(None,) * (labels.dim() - 1)))
    else:
        loss = _token_loss(logits, labels)
    if mask is not None:
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss.mean()
