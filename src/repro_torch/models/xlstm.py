"""xLSTM blocks: the port of the reference's ``repro/models/xlstm.py`` —
mLSTM (matrix memory) and sLSTM (scalar memory); the 350M config has no
separate FFN (d_ff = 0), the blocks carry their own projections.

The mLSTM recurrence (per head, exponential gating):
    C_t = f C_{t-1} + i v_t k_t^T ;  n_t = f n_{t-1} + i k_t
    h_t = (C_t q_t) / max(|n_t^T q_t|, 1)
Both recurrences run per token in f32, as the reference's ``lax.scan``,
and the gates are ``exp(-softplus(-g))`` (a stable sigmoid).  The decode
state is O(1) in the sequence length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init, rmsnorm, rmsnorm_init


def _gate(g):
    return torch.exp(-F.softplus(-g))


def mlstm_init(gen, d, n_heads, proj=2, dtype=torch.bfloat16):
    di = proj * d
    return {
        "wup": _init(gen, (d, 2 * di), dtype=dtype),          # [x_in, gate]
        "wqkv": _init(gen, (di, 3 * di), dtype=dtype),
        "wif": _init(gen, (di, 2 * n_heads), dtype=torch.float32),
        "norm": rmsnorm_init(di, gen.device),
        "wdown": _init(gen, (di, d), scale=1.0 / math.sqrt(di), dtype=dtype),
    }


def mlstm_apply(p, x, n_heads, *, cache=None, proj=2):
    """x: (B,S,D) -> (y, new_cache); cache = {"c": (B,H,hp,hp), "n":
    (B,H,hp)} in f32, the new cache a new dict of new tensors."""
    b, s, d = x.shape
    di = proj * d
    hp = di // n_heads
    up = x @ p["wup"]
    xi, gate = up[..., :di], up[..., di:]
    q, k, v = (t.reshape(b, s, n_heads, hp)
               for t in torch.chunk(xi @ p["wqkv"], 3, dim=-1))
    # the reference divides by a numpy float64, which JAX promotes to f32
    k = k.float() / math.sqrt(hp)
    gif = (xi.float() @ p["wif"]).reshape(b, s, n_heads, 2)
    ig = _gate(gif[..., 0])
    fg = _gate(gif[..., 1])                           # forget in (0,1)
    q, v = q.float(), v.float()

    if cache is None:
        c = torch.zeros((b, n_heads, hp, hp), dtype=torch.float32,
                        device=x.device)
        n = torch.zeros((b, n_heads, hp), dtype=torch.float32,
                        device=x.device)
    else:
        c, n = cache["c"], cache["n"]
    hs = []
    for t in range(s):
        q_t, k_t, v_t, i_t, f_t = q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t]
        c = c * f_t[:, :, None, None] + \
            i_t[:, :, None, None] * torch.einsum("bhp,bhq->bhpq", v_t, k_t)
        n = n * f_t[:, :, None] + i_t[:, :, None] * k_t
        num = torch.einsum("bhpq,bhq->bhp", c, q_t)
        den = torch.clamp(torch.abs(torch.einsum("bhq,bhq->bh", n, q_t)),
                          min=1.0)
        hs.append(num / den[:, :, None])
    h = torch.stack(hs, dim=1).reshape(b, s, di).to(x.dtype)
    h = rmsnorm(p["norm"], h) * F.silu(gate.float()).to(x.dtype)
    y = h @ p["wdown"]
    return y, None if cache is None else {"c": c, "n": n}


def slstm_init(gen, d, dtype=torch.bfloat16):
    return {
        "wg": _init(gen, (d, 4 * d), dtype=torch.float32),    # i,f,z,o
        "norm": rmsnorm_init(d, gen.device),
        "wout": _init(gen, (d, d), dtype=dtype),
    }


def slstm_apply(p, x, n_heads, *, cache=None):
    """x: (B,S,D) -> (y, new_cache); cache = {"c": (B,D)} in f32.
    ``n_heads`` is ignored, as in the reference."""
    b, s, d = x.shape
    g = (x.float() @ p["wg"]).reshape(b, s, 4, d)
    i = _gate(g[:, :, 0])
    f = _gate(g[:, :, 1])
    z = torch.tanh(g[:, :, 2])
    o = _gate(g[:, :, 3])
    c = torch.zeros((b, d), dtype=torch.float32, device=x.device) \
        if cache is None else cache["c"]
    hs = []
    for t in range(s):
        c = f[:, t] * c + i[:, t] * z[:, t]
        hs.append(o[:, t] * torch.tanh(c))
    h = torch.stack(hs, dim=1).to(x.dtype)
    y = rmsnorm(p["norm"], h) @ p["wout"]
    return y, None if cache is None else {"c": c}


def make_mlstm_cache(b, d, n_heads, proj=2, device="cuda"):
    di = proj * d
    hp = di // n_heads
    return {"c": torch.zeros((b, n_heads, hp, hp), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((b, n_heads, hp), dtype=torch.float32,
                             device=device)}


def make_slstm_cache(b, d, device="cuda"):
    return {"c": torch.zeros((b, d), dtype=torch.float32, device=device)}
