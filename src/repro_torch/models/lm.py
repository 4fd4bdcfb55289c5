"""Model assembly: one generic LM covering all ten configured families.

The port of the reference's ``repro/models/lm.py`` (``init_params`` and
the block inits, ``_tfm_block``, ``_embed_inputs``, ``forward``,
``make_caches``, ``_remat``).  The block programs are the reference's:

  dense / moe / vlm / audio : [attention or MLA] + [SwiGLU | MoE | GELU-MLP]
  hybrid (zamba2)           : Mamba-2 blocks + one *shared* attention block
                              applied every ``ssm.attn_every`` layers
  ssm (xlstm)               : the mLSTM blocks, then the sLSTM blocks

The reference stacks each group of layers and runs it with ``lax.scan``;
here the parameters are an :class:`LM` module with one module per layer
in each group, walked by a Python loop.  Parameter shapes, scales and
dtypes are the reference's: normals drawn in f32 and cast to the model
dtype (bf16 unless asked); norms, the router, the xLSTM gate weights and
the Mamba-2 decay parameters in f32.  Every parameter is trainable;
serving runs under ``torch.inference_mode()``.

On a mesh (``repro_torch.distributed``: the parameters ``DTensor``s placed
by ``param_shardings``, a mesh installed by ``context.use_mesh``) each
layer, the Zamba2 shared block, the frontend and the head gather their
parameters over ``data`` where they are used (the reference's per-layer
all-gather of the ZeRO axis), a recurrent layer's new state is written
into each rank's own shard of the stacked cache, and with
``cfg.seq_shard_acts`` the residual stream is constrained to (batch,
``model``, -) between blocks, as the reference's ``_constrain_acts``.
Without a mesh all of these are the identity.  Every family runs on a
mesh: the head or channel split of each block is its module's
(``layers``, ``mla``, ``mamba2``, ``xlstm``, ``moe``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.distributed import context as dctx
from repro_torch.models import layers as L
from repro_torch.models import mamba2, mla, moe, multimodal, xlstm
from repro_torch.models.config import ArchConfig


class Tree(nn.Module):
    """A nested dict of tensors as a module: ``tree["wq"]`` reads a
    parameter, ``tree["moe"]`` a sub-tree, and ``.to`` / ``state_dict``
    see every leaf.  Every leaf is a trainable parameter (it shares the
    given tensor's memory); :meth:`tree` gives the nested dict back."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The nested dict of this module's parameters (the same
        tensors)."""
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


def layer_groups(cfg: ArchConfig) -> dict:
    """The model's stacked layer groups and their depths, as the
    reference's ``init_params`` stacks them: ``mlstm`` / ``slstm`` of
    ``(n+1)//2`` and ``n//2`` layers (xLSTM), ``mamba`` (the Zamba2
    hybrid) or ``blocks`` (every transformer family)."""
    n = cfg.n_layers
    if cfg.xlstm:
        return {"mlstm": (n + 1) // 2, "slstm": n // 2}
    if cfg.ssm is not None:
        return {"mamba": n}
    return {"blocks": n}


class LM(nn.Module):
    """The parameters of one model: a :class:`Tree` for each unstacked
    part (``embed``, ``final_norm``, ``unembed``, ``shared_attn``,
    ``frontend``, ``head``) and a ``ModuleList`` of one :class:`Tree` per
    layer for each stacked group (:func:`layer_groups`), built from a
    nested dict whose groups are lists of one dict per layer."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            self.add_module(k, nn.ModuleList(Tree(b) for b in v)
                            if isinstance(v, list) else Tree(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def tree(self) -> dict:
        """The parameters as the nested dict :class:`LM` is built from
        (the same tensors): the trainer's and the checkpoint's view."""
        return {k: [b.tree() for b in m] if isinstance(m, nn.ModuleList)
                else m.tree() for k, m in self._modules.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def tfm_block_init(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    dev = gen.device
    blk = {"ln1": L.rmsnorm_init(d, dev), "ln2": L.rmsnorm_init(d, dev)}
    if cfg.mla is not None:
        blk["attn"] = mla.mla_init(gen, d, cfg.n_heads, cfg.mla, dtype)
    else:
        blk["attn"] = L.attn_init(gen, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                  dtype)
    if cfg.moe is not None:
        blk["moe"] = moe.moe_init(gen, d, cfg.moe, dtype)
    elif cfg.encoder_only:
        blk["mlp"] = L.gelu_mlp_init(gen, d, cfg.d_ff, dtype)
    else:
        blk["mlp"] = L.swiglu_init(gen, d, cfg.d_ff, dtype)
    return blk


def mamba_block_init(gen, cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    return {"ln": L.rmsnorm_init(cfg.d_model, gen.device),
            "mixer": mamba2.mamba2_init(gen, cfg.d_model, cfg.ssm, dtype)}


def mlstm_block_init(gen, cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    return {"ln": L.rmsnorm_init(cfg.d_model, gen.device),
            "mixer": xlstm.mlstm_init(gen, cfg.d_model, cfg.n_heads,
                                      dtype=dtype)}


def slstm_block_init(gen, cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    return {"ln": L.rmsnorm_init(cfg.d_model, gen.device),
            "mixer": xlstm.slstm_init(gen, cfg.d_model, dtype)}


_BLOCK_INITS = {"blocks": tfm_block_init, "mlstm": mlstm_block_init,
                "slstm": slstm_block_init, "mamba": mamba_block_init}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.bfloat16) -> LM:
    """Random parameters drawn from ``gen``, on ``gen``'s device (make the
    generator with ``torch.Generator(device=...).manual_seed(seed)``)."""
    d = cfg.d_model
    dev = gen.device
    tree = {"embed": L.embed_init(gen, cfg.vocab, d, dtype),
            "final_norm": L.rmsnorm_init(d, dev)}
    if not cfg.tie_embeddings:
        tree["unembed"] = L.unembed_init(gen, d, cfg.vocab, dtype)
    for name, n in layer_groups(cfg).items():
        tree[name] = [_BLOCK_INITS[name](gen, cfg, dtype) for _ in range(n)]
    if cfg.ssm is not None and not cfg.xlstm:
        # the Zamba2 shared attention block (one copy, reused)
        tree["shared_attn"] = {
            "ln": L.rmsnorm_init(d, dev),
            "attn": L.attn_init(gen, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                dtype)}
    if cfg.frontend == "audio":
        tree["frontend"] = multimodal.audio_frontend_init(gen, 512, d, dtype)
        tree["head"] = L.unembed_init(gen, d, cfg.vocab, dtype)
    elif cfg.frontend == "vision":
        tree["frontend"] = multimodal.vision_connector_init(
            gen, cfg.d_frontend, d, dtype)
    return LM(tree)


def shape_params(cfg: ArchConfig, *, device="cuda", dtype=torch.bfloat16,
                 fake_mode=None) -> LM:
    """The model's parameters as fake tensors on ``device``: their shapes
    and dtypes, nothing allocated (the reference's ``shape_params``, the
    dry-run path).  Built by :func:`init_params` under ``fake_mode`` (a
    new ``FakeTensorMode`` by default), whose later ops they take part
    in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mode or FakeTensorMode():
        return init_params(cfg, torch.Generator(device=device), dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of plain matrix products (JAX's ``checkpoint_dots_with_no_batch_dims``;
    batched products, such as attention's and the expert products,
    recompute)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ArchConfig):
    """Activation rematerialization of a layer body, as the reference's
    ``_remat``: ``"full"`` keeps only the layer's input, ``"dots"`` also
    the matmul outputs.  Values are unchanged; only memory moves."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def _constrain_acts(x, cfg: ArchConfig):
    """Sequence-parallel residual stream: (B, S, D) -> (batch, 'model',
    -), when ``cfg.seq_shard_acts`` is set and a mesh is active."""
    if not cfg.seq_shard_acts:
        return x
    baxes = dctx.batch_axes()
    if baxes is None:
        return x
    return dctx.constrain(x, baxes, "model", None)


def _tfm_block(blk, x, cfg: ArchConfig, cache, ci):
    blk = dctx.gather_data(blk)
    h = L.rmsnorm(blk["ln1"], x)
    if cfg.mla is not None:
        a, new_cache = mla.mla_attention(
            blk["attn"], h, n_heads=cfg.n_heads, cfg=cfg.mla,
            theta=cfg.rope_theta, cache=cache, cache_index=ci,
            causal_skip=cfg.block_causal)
    else:
        a, new_cache = L.attention(
            blk["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv, hd=cfg.hd,
            theta=cfg.rope_theta, causal=not cfg.encoder_only, cache=cache,
            cache_index=ci, causal_skip=cfg.block_causal)
    x = x + a
    h = L.rmsnorm(blk["ln2"], x)
    aux = None
    if cfg.moe is not None:
        f, aux = moe.moe_apply(blk["moe"], h, cfg.moe)
    elif cfg.encoder_only:
        f = L.gelu_mlp(blk["mlp"], h)
    else:
        f = L.swiglu(blk["mlp"], h)
    return x + f, new_cache, aux


def _mixer(mix, blk, x, cfg: ArchConfig, group, i):
    """One recurrent layer, ``x + mix(rmsnorm(x))`` (Mamba-2, mLSTM or
    sLSTM), its parameters gathered over ``data`` on a mesh.  With
    ``group`` (the group's stacked caches) it reads layer ``i``'s state
    and writes the new state back in place (on a mesh, into each rank's
    own shard)."""
    blk = dctx.gather_data(blk)

    def body(x, cache=None):
        y, new = mix(blk["mixer"], L.rmsnorm(blk["ln"], x), cache=cache)
        return x + y, new
    if group is None:
        return _remat(lambda x: body(x)[0], cfg)(x)
    x, new = body(x, {k: t[i] for k, t in group.items()})
    for k, t in new.items():
        dctx.write_slice(group[k], t.unsqueeze(0), 0, i)
    return x


def _embed_inputs(params, cfg: ArchConfig, batch):
    """tokens (+ frames / patches) -> (B, S, D) activations: audio frames
    through the frontend, vision patches through the connector and
    prepended to the tokens, else the tokens alone (also the VLM's decode:
    the vision context lives in the KV cache after prefill).  On a mesh
    the two parts of the VLM's input are joined with the batch split and
    the rest whole."""
    if cfg.frontend == "audio":
        return multimodal.audio_frontend(dctx.gather_data(params["frontend"]),
                                         batch["frames"])
    x = L.embed(dctx.gather_data(params["embed"]), batch["tokens"])
    if cfg.frontend == "vision" and "patches" in batch:
        vis = multimodal.vision_connector(
            dctx.gather_data(params["frontend"]), batch["patches"])
        x = torch.cat([dctx.batch_only(vis.to(x.dtype)),
                       dctx.batch_only(x)], dim=1)
    return x


def forward(params: LM, cfg: ArchConfig, batch, *, caches=None,
            cache_index=None):
    """Returns (logits, caches, aux).

    batch: {"tokens": (B, S)} (+ "frames" for audio, which replace the
    tokens, or "patches" for the VLM).  caches: from :func:`make_caches`
    (a leading layer axis) or None; updated in place and returned.

    The xLSTM runs all its mLSTM layers, then all its sLSTM layers (the
    reference's two scans).  The Zamba2 hybrid runs each run of
    ``attn_every`` Mamba-2 layers followed by the *shared* attention block
    (one copy of its weights, a KV cache for each application), then the
    leftover Mamba-2 layers.  ``aux`` is the mean MoE load-balance loss
    over the transformer layers, 0 for the recurrent families.
    """
    x = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.xlstm:
        for name, apply in (("mlstm", xlstm.mlstm_apply),
                            ("slstm", xlstm.slstm_apply)):
            mix = functools.partial(apply, n_heads=cfg.n_heads)
            group = None if caches is None else caches[name]
            for i, blk in enumerate(params[name]):
                x = _mixer(mix, blk, x, cfg, group, i)
    elif cfg.ssm is not None:
        mix = functools.partial(mamba2.mamba2_apply, cfg=cfg.ssm)
        every = cfg.ssm.attn_every
        group = None if caches is None else caches["mamba"]
        for i, blk in enumerate(params.mamba):
            x = _constrain_acts(_mixer(mix, blk, x, cfg, group, i), cfg)
            if (i + 1) % every:
                continue
            cch = None if caches is None else \
                {k: t[i // every] for k, t in caches["shared_attn"].items()}
            shared = dctx.gather_data(params["shared_attn"])
            a, _ = L.attention(
                shared["attn"], L.rmsnorm(shared["ln"], x),
                n_heads=cfg.n_heads, n_kv=cfg.n_kv, hd=cfg.hd,
                theta=cfg.rope_theta, causal=True, cache=cch,
                cache_index=None if cch is None else cache_index)
            x = x + a
    else:
        auxs = []
        for i, blk in enumerate(params.blocks):
            if caches is None:
                body = _remat(functools.partial(
                    _tfm_block, blk, cfg=cfg, cache=None, ci=cache_index),
                    cfg)
                x, _, moe_aux = body(x)
            else:
                cch = {k: t[i] for k, t in caches["blocks"].items()}
                x, _, moe_aux = _tfm_block(blk, x, cfg, cch, cache_index)
            x = _constrain_acts(x, cfg)
            auxs.append(aux if moe_aux is None else moe_aux["aux_loss"])
        aux = torch.stack(auxs).mean()
    x = dctx.batch_only(L.rmsnorm(params["final_norm"], x))
    if cfg.frontend == "audio":
        logits = L.unembed(dctx.gather_data(params["head"]), x)
    elif cfg.tie_embeddings:
        logits = L._mm(x, dctx.gather_data(params["embed"])["e"].T).float()
    else:
        logits = L.unembed(dctx.gather_data(params["unembed"]), x)
    return logits, caches, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def _stacked(n: int, one: dict) -> dict:
    """``n`` layers of the zero cache ``one``: a leading layer axis."""
    return {k: t.new_zeros((n, *t.shape)) for k, t in one.items()}


def make_caches(cfg: ArchConfig, b: int, s: int, dtype=torch.bfloat16,
                device="cuda", *, mesh=None, long_context: bool = False):
    """Decode caches with a leading layer axis, as the reference's.  The
    xLSTM's caches and the Mamba-2 state are f32 whatever ``dtype``.
    With ``mesh`` (a named ``DeviceMesh``) every leaf is a zero
    ``DTensor`` placed by ``sharding.cache_specs``, of which each rank
    makes only its own shard; with ``long_context`` too (a batch of one)
    the sequence is split over ``("data", "model")``."""
    if mesh is not None:
        from repro_torch.distributed import sharding as shd
        like = make_caches(cfg, b, s, dtype, device="meta")
        return shd.zero_caches(like, mesh, device, long_context=long_context)
    d = cfg.d_model
    if cfg.xlstm:
        n = layer_groups(cfg)
        return {"mlstm": _stacked(n["mlstm"], xlstm.make_mlstm_cache(
                    b, d, cfg.n_heads, device=device)),
                "slstm": _stacked(n["slstm"], xlstm.make_slstm_cache(
                    b, d, device=device))}
    if cfg.ssm is not None:
        return {"mamba": _stacked(cfg.n_layers, mamba2.make_mamba_cache(
                    b, d, cfg.ssm, dtype, device)),
                "shared_attn": _stacked(
                    cfg.n_layers // cfg.ssm.attn_every,
                    L.make_cache(b, cfg.n_kv, s, cfg.hd, dtype, device))}
    one = (mla.make_mla_cache(b, s, cfg.mla, dtype, device)
           if cfg.mla is not None else
           L.make_cache(b, cfg.n_kv, s, cfg.hd, dtype, device))
    return {"blocks": _stacked(cfg.n_layers, one)}
