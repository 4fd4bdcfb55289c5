"""The train step and its loss: the port of the reference's
``repro/train/step.py`` for every family (dense, MoE, MLA, the Mamba-2
hybrid, the xLSTM, the audio encoder and the VLM).

One step is the forward and backward of :func:`loss_fn` (optionally over
microbatches, whose gradients are summed in f32 as the reference's
``lax.scan`` does), then :func:`repro_torch.train.optimizer.adamw_update`.
PyTorch runs eagerly, so there is no ``jit``.  On a mesh the
parameters, the optimizer state and the batch are ``DTensor``s: each
gradient is redistributed to its parameter's placements before the
update, and the metrics are gathered to plain 0-dim tensors.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import cross_entropy
from repro_torch.train import optimizer as opt


def loss_fn(params: lm.LM, cfg: ArchConfig, batch, *, aux_weight=0.01):
    """The cross-entropy plus ``aux_weight`` times the MoE load-balance
    loss; returns ``(loss, aux)``.  The VLM's loss covers its text region
    only (the patches carry no labels); an encoder's is masked by
    ``batch["mask"]`` and unshifted; every other model's is next-token."""
    logits, _, aux = lm.forward(params, cfg, batch)
    if cfg.frontend == "vision":
        logits = logits[:, -batch["labels"].shape[1]:, :]
    if cfg.encoder_only:
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    else:
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
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if dctx.is_sharded(g) else g for g, p in zip(grads, leaves)]
        return dctx.whole(loss.detach()), dctx.whole(aux.detach()), grads

    def train_step(params, state, batch):
        tree = params.tree()
        if microbatch and microbatch > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatch:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"microbatch {microbatch}")
            n = b // microbatch
            chunks = [{k: _rows(v, i * n, n) for k, v in batch.items()}
                      for i in range(microbatch)]
            gsum = [torch.zeros_like(p, dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
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
                               "grad_norm": dctx.whole(gnorm)}

    return train_step


def _rows(x, start: int, n: int):
    """Rows ``start : start + n`` of a batch tensor; on a mesh, gathered
    and split over the batch axes again."""
    if not dctx.is_sharded(x):
        return x[start:start + n]
    return shd.place(x.full_tensor()[start:start + n],
                     shd.batch_sharding(x.device_mesh, (n,)))


def synth_batch(cfg: ArchConfig, batch: int, seq: int,
                gen: torch.Generator | None = None):
    """A synthetic batch with the model's inputs, drawn from ``gen`` on its
    device (by default a generator on the card seeded with 0), in the
    reference's dtypes: for the audio encoder bf16 ``frames`` (batch, seq,
    512), ``labels`` in ``[0, vocab)`` and a ``mask`` of ones; for the VLM
    ``max(seq - n_patches, 8)`` ``tokens``, which are their own ``labels``
    as in the reference, after bf16 ``patches`` (batch, n_patches,
    d_frontend); for the others uniform
    ``tokens`` that are their own ``labels``.  ``jax.random``'s stream
    cannot be reproduced in torch, so tests that compare with the
    reference draw their batches with numpy instead."""
    gen = gen if gen is not None else \
        torch.Generator(device="cuda").manual_seed(0)
    dev = gen.device

    def ids(shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             dtype=torch.int32, device=dev)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    if cfg.frontend == "audio":
        return {"frames": normal((batch, seq, 512)),
                "labels": ids((batch, seq)),
                "mask": torch.ones((batch, seq), dtype=torch.float32,
                                   device=dev)}
    if cfg.frontend == "vision":
        # the reference draws tokens and labels with one key: they are equal
        toks = ids((batch, max(seq - cfg.n_patches, 8)))
        return {"tokens": toks,
                "patches": normal((batch, cfg.n_patches, cfg.d_frontend)),
                "labels": toks}
    toks = ids((batch, seq))
    return {"tokens": toks, "labels": toks}
