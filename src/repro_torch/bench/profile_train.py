"""Where a training step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_train [--leg moe|dense|all] [--steps 4]
    PYTHONPATH=src python -m repro_torch.bench.profile_train --arch hubert-xlarge

:data:`LEGS` holds the training legs, which ``chip_smoke.py`` reads
too: ``moe`` is Phi-3.5-MoE at full width, depth cut to 2 layers, bf16
parameters from a seeded generator, ``train()``'s default traffic (8 x
128 tokens of the synthetic Zipf stream, lr 3e-4); ``dense`` is the 100M
example's model (``repro-100m``) at 4 x 128 tokens, lr 1e-3.
:data:`FAMILY_LEGS` holds the other families' legs (``--arch``), which
``chip_smoke.py``'s ``[train-families]`` phase reads: each family at full
width (depth cut where its AdamW state would not fit the card), bf16
parameters from a generator seeded with 0, one ``synth_batch`` (the
frontend families cannot take the token stream) passed at every step, lr
3e-4 (LLaVA's 2e-5).  Each leg is profiled at its own batch and lr.
After two warm-up steps each leg runs ``--steps`` train steps timed on
the host clock around a
``torch.cuda.synchronize()``, then the step's two halves timed the same
way on their own (the forward and backward, ``loss_fn`` and
``torch.autograd.grad``; the AdamW update on those gradients), then
``--steps`` steps under ``torch.profiler``.
Prints one JSON line a leg: wall milliseconds a step and a half, device
milliseconds a step, the device's busy share, ``group_matmul``'s share of
the device time and its launches, kernel launches a step, the top
kernels and operators by device time, and peak device memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.bench.profile_serve import device_summary
from repro_torch.data import SyntheticTokenStream
from repro_torch.kernels import group_matmul
from repro_torch.launch.train_100m import CFG_100M
from repro_torch.models import lm
from repro_torch.train.optimizer import adamw_init, adamw_update, tree_leaves
from repro_torch.train.step import loss_fn, make_train_step, synth_batch

#: leg -> (config, traffic): the training legs of ``chip_smoke.py``.
#: ``moe`` is Phi-3.5-MoE with its depth cut 32 -> 2 layers (2.863 B
#: parameters: bf16 parameters and gradients plus f32 master, m and v are
#: 45.8 GB; 3 layers' 66.6 GB would leave too little of the card's 80 GB
#: for AdamW's temporaries, the backward's transposed expert weights and
#: the activations) at ``train()``'s default traffic (1,024 tokens a step:
#: expert capacity 160, so every expert product takes the kernel's tiled
#: shape at tile_m 128), the first step a warm-up; ``dense`` is the 100M
#: example's model
LEGS = {
    "moe": (dataclasses.replace(configs.get_arch("phi35_moe_42b"),
                                n_layers=2),
            dict(steps=6, batch=8, seq=128, lr=3e-4)),
    "dense": (CFG_100M, dict(steps=30, batch=4, seq=128, lr=1e-3)),
}


def _family(arch: str, **cut):
    return dataclasses.replace(configs.get_arch(configs.ALIASES[arch]),
                               **cut)


#: arch -> (config, traffic) of the other families' training legs (one
#: ``synth_batch`` of ``batch`` x ``seq`` at every step).  bf16 parameters
#: and gradients plus f32 master, m and v are 16 bytes a parameter:
#: HuBERT-XLarge whole (0.96 B parameters, 15 GB; 2 x 512 frames);
#: LLaVA-NeXT-Mistral-7B cut 32 -> 8 layers (7.24 B need 116 GB; 8 layers
#: are 2.01 B, 32 GB), its 2,880 anyres patches and 16 text tokens;
#: DeepSeek-V2-Lite cut 27 -> 4 layers (16.21 B need 259 GB; 4 layers are
#: 2.76 B, 44 GB), 4 x 128 tokens; Zamba2-1.2B (1.12 B, 18 GB) and
#: xLSTM-350M (0.30 B, 5 GB) whole, 4 x 128.  The xLSTM's per-token mLSTM
#: keeps its (4, 4, 512, 512) f32 state for the backward at every token
#: (tens of GB over 12 layers of 128 tokens), so its leg recomputes each
#: layer's forward in the backward (``remat="full"``, the reference's knob).
#: Every leg trains at lr 3e-4 but LLaVA's, at LLaVA-NeXT's own
#: fine-tuning rate for its language model, 2e-5: its 16 text tokens are
#: learnt in one step at 3e-4 (10.65 -> 0.18), and Adam's momentum then
#: overshoots (9.40, 21.15 at steps 3 and 4; NVIDIA H100 80GB HBM3, 700 W)
FAMILY_LEGS = {
    "hubert-xlarge": (_family("hubert-xlarge"),
                      dict(steps=4, batch=2, seq=512, lr=3e-4)),
    "llava-next-mistral-7b": (_family("llava-next-mistral-7b", n_layers=8),
                              dict(steps=4, batch=1, seq=2880 + 16,
                                   lr=2e-5)),
    "deepseek-v2-lite-16b": (_family("deepseek-v2-lite-16b", n_layers=4),
                             dict(steps=4, batch=4, seq=128, lr=3e-4)),
    "zamba2-1.2b": (_family("zamba2-1.2b"),
                    dict(steps=4, batch=4, seq=128, lr=3e-4)),
    "xlstm-350m": (_family("xlstm-350m", remat="full"),
                   dict(steps=4, batch=4, seq=128, lr=3e-4)),
}


def train_profile(cfg, device, *, batch: int, seq: int, lr: float,
                  steps: int, synth: bool = False) -> dict:
    """Profile ``steps`` train steps of ``cfg`` at learning rate ``lr`` on
    ``device``: on the synthetic Zipf stream, or with ``synth`` on one
    ``synth_batch`` at every step."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen)
    state = adamw_init(params.tree())
    step = make_train_step(cfg, lr=lr)
    if synth:
        fixed = synth_batch(cfg, batch, seq, gen)

        def next_batch():
            return fixed
    else:
        pipe = SyntheticTokenStream(cfg.vocab, batch, seq, seed=0)

        def next_batch():
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in next(pipe).items()}

    def run(n):
        nonlocal params, state
        for _ in range(n):
            params, state, _ = step(params, state, next_batch())
        sync()

    run(2)                                       # warm-up
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    before = group_matmul.launches
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    gm_launches = (group_matmul.launches - before) / steps
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    leaves = tree_leaves(params.tree())
    fb_s = opt_s = 0.0
    for _ in range(steps):                       # the halves on their own
        b = next_batch()
        t0 = time.perf_counter()
        loss, _ = loss_fn(params, cfg, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        sync()
        t1 = time.perf_counter()
        adamw_update(grads, state, leaves, lr=lr)
        sync()
        fb_s += t1 - t0
        opt_s += time.perf_counter() - t1
        del grads

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        run(steps)
    return dict(
        device=(torch.cuda.get_device_name(0) if cuda else "cpu"),
        arch=cfg.name, n_layers=cfg.n_layers, params=cfg.param_count(),
        batch=batch, seq=seq, lr=lr, steps=steps, wall_ms_per_step=wall_ms,
        tokens_per_s=batch * seq / (wall_ms / 1e3),
        fwd_bwd_wall_ms=fb_s * 1e3 / steps,
        adamw_wall_ms=opt_s * 1e3 / steps,
        group_matmul_launches_per_step=gm_launches, peak_mem_bytes=peak,
        **device_summary(prof, steps, wall_ms))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", choices=[*LEGS, "all"], default="all")
    ap.add_argument("--arch", choices=[*FAMILY_LEGS, "all"],
                    help="profile the other families' legs instead")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    if ns.arch:
        legs = {a: FAMILY_LEGS[a] for a in
                (FAMILY_LEGS if ns.arch == "all" else [ns.arch])}
    else:
        legs = {a: LEGS[a] for a in (LEGS if ns.leg == "all" else [ns.leg])}
    out = []
    for leg, (cfg, traffic) in legs.items():
        row = dict(leg=leg, **train_profile(
            cfg, ns.device, batch=traffic["batch"], seq=traffic["seq"],
            lr=traffic["lr"], steps=ns.steps, synth=bool(ns.arch)))
        print(json.dumps(row), flush=True)
        out.append(row)
        if ns.device == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
