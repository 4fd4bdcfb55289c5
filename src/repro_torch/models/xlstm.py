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

from repro_torch.distributed import context as dctx
from repro_torch.models import layers as L
from repro_torch.models.layers import _init, rmsnorm_init


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


def _mlstm_scan(q, k, v, gif, *state):
    """The per-head mLSTM recurrence on q, k, v (B, S, di) and the gate
    pre-activations gif (B, S, 2·H), from ``state`` = (c, n) or zeros.
    ``H`` is what the tensors hold (a rank's own heads on a mesh).
    Returns h (B, S, di) in q's dtype, c and n."""
    b, s, di = q.shape
    n_heads = gif.shape[-1] // 2
    hp = di // n_heads
    dtype = q.dtype
    q, k, v = (t.reshape(b, s, n_heads, hp) for t in (q, k, v))
    # the reference divides by a numpy float64, which JAX promotes to f32
    k = k.float() / math.sqrt(hp)
    gif = gif.reshape(b, s, n_heads, 2)
    ig = _gate(gif[..., 0])
    fg = _gate(gif[..., 1])                           # forget in (0,1)
    q, v = q.float(), v.float()

    if not state:
        c = torch.zeros((b, n_heads, hp, hp), dtype=torch.float32,
                        device=q.device)
        n = torch.zeros((b, n_heads, hp), dtype=torch.float32,
                        device=q.device)
    else:
        c, n = state
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
    return torch.stack(hs, dim=1).reshape(b, s, di).to(dtype), c, n


def mlstm_apply(p, x, n_heads, *, cache=None, proj=2):
    """x: (B,S,D) -> (y, new_cache); cache = {"c": (B,H,hp,hp), "n":
    (B,H,hp)} in f32, the new cache a new dict of new tensors.

    On a mesh ``wup``'s [x_in, gate] and ``wqkv``'s [q, k, v] products are
    regathered along their features (a column split cuts elsewhere than at
    the parts' edges), then q, k, v and the gates split by head over
    ``model`` (where the heads divide it) for the recurrence under
    ``local_map``; the norm reduces over the whole ``di`` and ``wdown``
    is row-parallel."""
    b, s, d = x.shape
    di = proj * d
    up = dctx.batch_only(dctx.batch_only(x) @ p["wup"])
    xi, gate = up[..., :di], up[..., di:]
    q, k, v = torch.chunk(dctx.batch_only(xi @ p["wqkv"]), 3, dim=-1)
    gif = xi.float() @ p["wif"]
    state = () if cache is None else (cache["c"], cache["n"])
    if dctx.is_sharded(x):
        batch, heads = dctx.batch_axes(), dctx.heads_axis(n_heads)
        hp = di // n_heads
        gate = dctx.constrain(gate, batch, None, heads)
        ins = [L._placed(t, batch, None, heads) for t in (q, k, v, gif)]
        outs = [ins[0][1], dctx.fitted_placements(
                    (b, n_heads, hp, hp), batch, heads, None, None),
                dctx.fitted_placements((b, n_heads, hp), batch, heads, None)]
        ins += list(zip(state, outs[1:]))
        h, c, n = L._local(_mlstm_scan, outs, *ins)
    else:
        h, c, n = _mlstm_scan(q, k, v, gif, *state)
    h = L.rmsnorm(p["norm"], h) * F.silu(gate.float()).to(x.dtype)
    y = L._row_parallel(h, p["wdown"])
    return y, None if cache is None else {"c": c, "n": n}


def slstm_init(gen, d, dtype=torch.bfloat16):
    return {
        "wg": _init(gen, (d, 4 * d), dtype=torch.float32),    # i,f,z,o
        "norm": rmsnorm_init(d, gen.device),
        "wout": _init(gen, (d, d), dtype=dtype),
    }


def _slstm_scan(g, *state):
    """The elementwise sLSTM recurrence on the gate pre-activations g (B,
    S, 4, D), from ``state`` = (c,) or zeros; ``D`` is what g holds (a
    rank's own slice of the width on a mesh).  Returns h (B, S, D) in
    f32 and c."""
    b, s, _, d = g.shape
    i = _gate(g[:, :, 0])
    f = _gate(g[:, :, 1])
    z = torch.tanh(g[:, :, 2])
    o = _gate(g[:, :, 3])
    c = torch.zeros((b, d), dtype=torch.float32, device=g.device) \
        if not state else state[0]
    hs = []
    for t in range(s):
        c = f[:, t] * c + i[:, t] * z[:, t]
        hs.append(o[:, t] * torch.tanh(c))
    return torch.stack(hs, dim=1), c


def slstm_apply(p, x, n_heads, *, cache=None):
    """x: (B,S,D) -> (y, new_cache); cache = {"c": (B,D)} in f32.
    ``n_heads`` is ignored, as in the reference.

    On a mesh the gates' product (D, 4·D) is regathered along its features
    (a column split puts whole gates on each rank) and split along D over
    ``model`` (where it divides), matching the ``c`` cache, for the
    recurrence under ``local_map``; the norm reduces over the whole D and
    ``wout`` is row-parallel."""
    b, s, d = x.shape
    g = dctx.batch_only(dctx.batch_only(x).float() @ p["wg"]).reshape(
        b, s, 4, d)
    state = () if cache is None else (cache["c"],)
    if dctx.is_sharded(x):
        batch, width = dctx.batch_axes(), dctx.heads_axis(d)
        outs = [dctx.fitted_placements((b, s, d), batch, None, width),
                dctx.fitted_placements((b, d), batch, width)]
        ins = [L._placed(g, batch, None, None, width)]
        h, c = L._local(_slstm_scan, outs, *ins, *zip(state, outs[1:]))
    else:
        h, c = _slstm_scan(g, *state)
    y = L._row_parallel(L.rmsnorm(p["norm"], h.to(x.dtype)), p["wout"])
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
