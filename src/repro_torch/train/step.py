"""The train step and its loss: the port of the reference's
``repro/train/step.py`` for the text models (dense, MoE, MLA, the
Mamba-2 hybrid and the xLSTM).  The audio and vision families' batches
and losses (frames, patches, the text-region mask) are not ported yet
and raise (ROADMAP.md, Queue 1, training the new families).

One step is the forward and backward of :func:`loss_fn` (optionally over
microbatches, whose gradients are summed in f32 as the reference's
``lax.scan`` does), then :func:`repro_torch.train.optimizer.adamw_update`.
PyTorch runs eagerly, so there is no ``jit``; the reference's sharding
annotations are identity on one device and have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import cross_entropy
from repro_torch.train import optimizer as opt


def _check_text_model(cfg: ArchConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: training with the {cfg.frontend} frontend is not "
            "ported yet (ROADMAP.md, Queue 1, training the new families)")


def loss_fn(params: lm.LM, cfg: ArchConfig, batch, *, aux_weight=0.01):
    """Next-token cross-entropy plus ``aux_weight`` times the MoE
    load-balance loss.  Returns ``(loss, aux)``."""
    _check_text_model(cfg)
    logits, _, aux = lm.forward(params, cfg, batch)
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss + aux_weight * aux, aux


def make_train_step(cfg: ArchConfig, *, lr=3e-4, microbatch: int | None = None,
                    aux_weight=0.01):
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``.  ``params`` is an :class:`lm.LM` and ``opt_state`` an
    :class:`opt.AdamWState` over ``params.tree()``, both updated in
    place; ``batch`` holds tensors on the parameters' device; the metrics
    (``loss``, ``aux_loss``, ``grad_norm``) are 0-dim tensors.

    microbatch: split the batch into this many sequential chunks and
    accumulate their gradients (the activation-memory lever).
    """

    def grads_of(params, batch):
        leaves = opt.tree_leaves(params.tree())
        loss, aux = loss_fn(params, cfg, batch, aux_weight=aux_weight)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), aux.detach(), grads

    def train_step(params, state, batch):
        tree = params.tree()
        if microbatch and microbatch > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatch:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"microbatch {microbatch}")
            chunks = [{k: v[i * (b // microbatch):(i + 1) * (b // microbatch)]
                       for k, v in batch.items()} for i in range(microbatch)]
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                    for p in opt.tree_leaves(tree)]
            lsum = asum = 0.0
            for mb in chunks:
                loss, aux, grads = grads_of(params, mb)
                for s, g in zip(gsum, grads):
                    s.add_(g)
                lsum, asum = lsum + loss, asum + aux
            grads = [s / microbatch for s in gsum]
            loss, aux = lsum / microbatch, asum / microbatch
        else:
            loss, aux, grads = grads_of(params, batch)
        _, state, gnorm = opt.adamw_update(grads, state, opt.tree_leaves(tree),
                                           lr=lr)
        return params, state, {"loss": loss, "aux_loss": aux,
                               "grad_norm": gnorm}

    return train_step


def synth_batch(cfg: ArchConfig, batch: int, seq: int,
                gen: torch.Generator | None = None):
    """A synthetic token batch (uniform ids in ``[0, vocab)``) drawn from
    ``gen`` on its device (by default a generator on the card seeded with
    0).  ``jax.random``'s stream cannot be reproduced in torch, so tests
    that compare with the reference draw their batches from
    :class:`repro_torch.data.SyntheticTokenStream` instead."""
    _check_text_model(cfg)
    gen = gen if gen is not None else \
        torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32, device=gen.device)
    return {"tokens": toks, "labels": toks}
