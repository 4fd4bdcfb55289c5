"""Mamba-2 SSD block (as used by Zamba2): the port of the reference's
``repro/models/mamba2.py``.

State-space recurrence per head: H_t = a_t · H_{t-1} + x_t ⊗ B_t, with
y_t = C_t · H_t.  Without a cache it is computed chunkwise (the SSD
algorithm: quadratic attention-like form inside a chunk, linear
recurrence across chunks, one Python step per chunk where the reference
takes one ``lax.scan`` step).  Any call *with* a cache, the serving
prefill included, runs the exact per-token recurrence, as the
reference's.  The SSD state is f32 whatever the cache's dtype (decay
products underflow in bf16), and so are ``a_log`` and ``dt_bias``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx
from repro_torch.models import layers as L
from repro_torch.models.layers import _init, rmsnorm_init


def mamba2_init(gen, d, cfg, dtype=torch.bfloat16):
    di = cfg.expand * d
    nh, ds = cfg.n_heads, cfg.d_state
    assert di % nh == 0
    dev = gen.device
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "win": _init(gen, (d, 2 * di + 2 * nh * ds + nh), dtype=dtype),
        "conv": _init(gen, (cfg.d_conv, di), scale=0.5, dtype=dtype),
        "a_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "dnorm": rmsnorm_init(di, dev),
        "wout": _init(gen, (di, d), scale=1.0 / math.sqrt(di), dtype=dtype),
    }


def _ssd_chunk_scan(xh, a, b, c, chunk):
    """Chunkwise SSD.  xh: (B,S,nh,hp), a: (B,S,nh) decay in (0,1),
    b/c: (B,S,nh,ds).  Returns (B,S,nh,hp)."""
    bsz, s, nh, hp = xh.shape
    ds = b.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    out_dtype = xh.dtype
    # state recurrence in f32 (decay products underflow in bf16)
    xh, a, b, c = (t.float() for t in (xh, a, b, c))

    def r(t):   # (B, S, ...) -> (nc, B, chunk, ...)
        return t.reshape(bsz, nc, chunk, *t.shape[2:]).transpose(0, 1)
    xh, a, b, c = r(xh), r(a), r(b), r(c)
    la = torch.log(torch.clamp(a, min=1e-8))
    cum = torch.cumsum(la, dim=2)                       # (nc,B,chunk,nh)
    li = torch.tril(torch.ones((chunk, chunk), device=xh.device))
    li = li[None, :, :, None] > 0

    h = torch.zeros((bsz, nh, hp, ds), dtype=torch.float32,
                    device=xh.device)
    ys = []
    for i in range(nc):
        xh_c, cum_c, b_c, c_c = xh[i], cum[i], b[i], c[i]
        # intra-chunk: y_t += C_t · Σ_{u<=t} (prod_{u<v<=t} a_v) x_u B_u^T
        seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]   # (B,t,u,nh)
        w = torch.exp(torch.where(li, seg, -math.inf))       # decay weights
        cb = torch.einsum("bthn,buhn->btuh", c_c, b_c)       # (B,t,u,nh)
        y = torch.einsum("btuh,buhp->bthp", cb * w, xh_c)
        # inter-chunk: contribution of the carried state
        dec = torch.exp(cum_c)                               # (B,t,nh)
        y = y + torch.einsum("bthn,bhpn->bthp", c_c, h) * dec[..., None]
        # state update for the next chunk
        rem = torch.exp(cum_c[:, -1:, :] - cum_c)            # decay to end
        h = h * torch.exp(cum_c[:, -1])[:, :, None, None] + \
            torch.einsum("bthp,bthn->bhpn", xh_c * rem[..., None], b_c)
        ys.append(y)
    out = torch.stack(ys, dim=1)                        # (B,nc,chunk,nh,hp)
    return out.reshape(bsz, s, nh, hp).to(out_dtype)


def _scan(xin, bc, dt, conv, a_log, dt_bias, *state, cfg):
    """The per-channel and per-head part of the block: the depthwise
    causal conv, the decay and the SSD (chunked without a cache, the exact
    per-token recurrence from ``state`` = (conv, h) with one).  xin (B, S,
    di), bc (B, S, nh·2·ds), dt (B, S, nh) and the parameters hold as many
    heads as they are given (a rank's own on a mesh).  Returns y (B, S,
    di), and with a state also the new conv window and h."""
    bsz, s, di = xin.shape
    nh = dt.shape[-1]
    hp = di // nh
    dtype = xin.dtype
    b, c = torch.chunk(bc.reshape(bsz, s, nh, 2 * cfg.d_state), 2, dim=-1)

    # depthwise causal conv over the sequence
    if not state:
        pad = torch.zeros((bsz, cfg.d_conv - 1, di), dtype=xin.dtype,
                          device=xin.device)
    else:
        pad = state[0]
    xpad = torch.cat([pad, xin], dim=1)
    xc = sum(xpad[:, i:i + s, :] * conv[i] for i in range(cfg.d_conv))
    xc = F.silu(xc.float()).to(dtype)

    dt = F.softplus(dt.float() + dt_bias)                       # (B,S,nh)
    a = torch.exp(-torch.exp(a_log)[None, None] * dt)           # decay
    xh = xc.reshape(bsz, s, nh, hp) * dt[..., None].to(dtype)   # dt·x
    bmat, cmat = b.to(dtype), c.to(dtype)

    if not state:
        y = _ssd_chunk_scan(xh, a, bmat, cmat, min(cfg.chunk, s))
        return y.reshape(bsz, s, di)
    # exact recurrence, one step at a time
    h = state[1].float()
    ys = []
    for t in range(s):
        h = h * a[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xh[:, t].float(), bmat[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", cmat[:, t].float(), h))
    y = torch.stack(ys, dim=1).to(dtype)
    return (y.reshape(bsz, s, di), xpad[:, -(cfg.d_conv - 1):, :],
            h.to(state[1].dtype))


def mamba2_apply(p, x, cfg, *, cache=None):
    """x: (B,S,D) -> (y, new_cache).

    cache: {"conv": (B, d_conv-1, di), "h": (B,nh,hp,ds)}; the new cache
    is a new dict of new tensors, as the reference's.

    On a mesh the fused projection [z, x, B, C, dt] is regathered along
    its features (its parts sit at uneven offsets, so a column split cuts
    inside them); z and x then split by channel and B, C and dt by head
    over ``model`` (where the heads divide it), matching ``conv`` and the
    ``conv`` / ``h`` caches, and the conv and the scan run under
    ``local_map`` on each rank's batch rows and heads.  The gated RMSNorm
    reduces over the whole ``di``; ``wout`` is row-parallel.
    """
    bsz, s, d = x.shape
    di = cfg.expand * d
    nh, ds = cfg.n_heads, cfg.d_state
    proj = dctx.batch_only(dctx.batch_only(x) @ p["win"])
    z, xin, bc, dt = torch.split(proj, [di, di, 2 * nh * ds, nh], dim=-1)
    state = () if cache is None else (cache["conv"], cache["h"])
    scan = functools.partial(_scan, cfg=cfg)
    if dctx.is_sharded(x):
        batch, heads = dctx.batch_axes(), dctx.heads_axis(nh)
        z = dctx.constrain(z, batch, None, heads)
        ins = [L._placed(t, batch, None, heads) for t in (xin, bc, dt)]
        ins += [L._placed(p["conv"], None, heads),
                L._placed(p["a_log"], heads), L._placed(p["dt_bias"], heads)]
        if state:
            ins += [L._placed(state[0], batch, None, heads),
                    L._placed(state[1], batch, heads, None, None)]
        out = L._local(scan, [pl for _, pl in ins[:1] + ins[6:]], *ins)
    else:
        out = scan(xin, bc, dt, p["conv"], p["a_log"], p["dt_bias"], *state)
    y, new_cache = (out, None) if cache is None else \
        (out[0], {"conv": out[1], "h": out[2]})
    y = L.rmsnorm(p["dnorm"], y) * F.silu(z.float()).to(x.dtype)
    return L._row_parallel(y, p["wout"]), new_cache


def make_mamba_cache(bsz, d, cfg, dtype=torch.bfloat16, device="cuda"):
    di = cfg.expand * d
    # SSD state kept in f32 (decay products underflow in bf16)
    return {"conv": torch.zeros((bsz, cfg.d_conv - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((bsz, cfg.n_heads, di // cfg.n_heads,
                              cfg.d_state), dtype=torch.float32,
                             device=device)}
