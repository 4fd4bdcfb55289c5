"""Model assembly: the dense / MoE transformer language model.

The port of the transformer branch of the reference's ``repro/models/lm.py``
(``init_params``, ``tfm_block_init``, ``_tfm_block``, the text path of
``_embed_inputs``, ``forward``, ``make_caches``).  The reference stacks its
layers and runs them with ``lax.scan``; here the parameters are an
:class:`LM` module whose ``blocks`` are one module per layer, walked by a
Python loop.  Parameter shapes, scales and dtypes are the reference's:
normals drawn in f32 and cast to the model dtype (bf16 unless asked),
norms and the router in f32.

The other families raise ``NotImplementedError``: xLSTM, Mamba-2 hybrid,
MLA, audio and vision wait for their slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig


class Tree(nn.Module):
    """A nested dict of tensors as a module: ``tree["wq"]`` reads a
    parameter, ``tree["moe"]`` a sub-tree, and ``.to`` / ``state_dict``
    see every leaf.  Parameters carry no gradient (serving only)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Tree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


class LM(nn.Module):
    """The parameters of one model: ``embed``, ``final_norm``, ``unembed``
    and one :class:`Tree` per layer in ``blocks``."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = Tree(tree["embed"])
        self.final_norm = Tree(tree["final_norm"])
        if "unembed" in tree:
            self.unembed = Tree(tree["unembed"])
        self.blocks = nn.ModuleList(Tree(b) for b in tree["blocks"])

    def __getitem__(self, key):
        return getattr(self, key)


def _check_supported(cfg: ArchConfig) -> None:
    what = None
    if cfg.xlstm:
        what = "xLSTM"
    elif cfg.ssm is not None:
        what = "Mamba-2 hybrid"
    elif cfg.mla is not None:
        what = "MLA attention"
    elif cfg.frontend != "none" or cfg.encoder_only:
        what = f"{cfg.frontend} frontend / encoder-only"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {what} family is not ported yet "
            "(ROADMAP Queue 1 item 10)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def tfm_block_init(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    dev = gen.device
    blk = {"ln1": L.rmsnorm_init(d, dev), "ln2": L.rmsnorm_init(d, dev),
           "attn": L.attn_init(gen, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                               dtype)}
    if cfg.moe is not None:
        blk["moe"] = moe.moe_init(gen, d, cfg.moe, dtype)
    else:
        blk["mlp"] = L.swiglu_init(gen, d, cfg.d_ff, dtype)
    return blk


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.bfloat16) -> LM:
    """Random parameters drawn from ``gen``, on ``gen``'s device (make the
    generator with ``torch.Generator(device=...).manual_seed(seed)``)."""
    _check_supported(cfg)
    d = cfg.d_model
    tree = {"embed": L.embed_init(gen, cfg.vocab, d, dtype),
            "final_norm": L.rmsnorm_init(d, gen.device)}
    if not cfg.tie_embeddings:
        tree["unembed"] = L.unembed_init(gen, d, cfg.vocab, dtype)
    tree["blocks"] = [tfm_block_init(gen, cfg, dtype)
                      for _ in range(cfg.n_layers)]
    return LM(tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _tfm_block(blk, x, cfg: ArchConfig, cache, ci):
    h = L.rmsnorm(blk["ln1"], x)
    a, new_cache = L.attention(
        blk["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv, hd=cfg.hd,
        theta=cfg.rope_theta, causal=True, cache=cache, cache_index=ci,
        causal_skip=cfg.block_causal)
    x = x + a
    h = L.rmsnorm(blk["ln2"], x)
    aux = None
    if cfg.moe is not None:
        f, aux = moe.moe_apply(blk["moe"], h, cfg.moe)
    else:
        f = L.swiglu(blk["mlp"], h)
    return x + f, new_cache, aux


def _embed_inputs(params, cfg: ArchConfig, batch):
    """tokens -> (B, S, D) activations (the text path)."""
    return L.embed(params["embed"], batch["tokens"])


def forward(params: LM, cfg: ArchConfig, batch, *, caches=None,
            cache_index=None):
    """Returns (logits, caches, aux).

    batch: {"tokens": (B, S)}.  caches: from :func:`make_caches` (a
    leading layer axis) or None; updated in place and returned.
    """
    _check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    auxs = []
    for i, blk in enumerate(params.blocks):
        cch = None if caches is None else {
            "k": caches["blocks"]["k"][i], "v": caches["blocks"]["v"][i]}
        x, _, aux = _tfm_block(blk, x, cfg, cch, cache_index)
        auxs.append(aux["aux_loss"] if aux else
                    torch.zeros((), dtype=torch.float32, device=x.device))
    aux = torch.stack(auxs).mean()
    x = L.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L._mm(x, params["embed"]["e"].T).float()
    else:
        logits = L.unembed(params["unembed"], x)
    return logits, caches, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def make_caches(cfg: ArchConfig, b: int, s: int, dtype=torch.bfloat16,
                device="cuda"):
    """Decode caches with a leading layer axis, as the reference's."""
    _check_supported(cfg)
    flat = L.make_cache(cfg.n_layers * b, cfg.n_kv, s, cfg.hd, dtype, device)
    return {"blocks": {k: t.view(cfg.n_layers, b, *t.shape[1:])
                       for k, t in flat.items()}}
