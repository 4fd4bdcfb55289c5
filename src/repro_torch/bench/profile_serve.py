"""Where a decode step's time goes, serving a model on the card.

    PYTHONPATH=src python -m repro_torch.bench.profile_serve [--steps 16]
    PYTHONPATH=src python -m repro_torch.bench.profile_serve \
        --arch deepseek-v2-lite-16b

Builds the model (``--arch``, Phi-3.5-MoE by default) at full width with
the depth cut of ``chip_smoke.py`` where it has one (Phi-3.5-MoE: 4
layers; the other configs whole), bf16 weights from a seeded generator,
prefills the first
wave of ``examples/serve_moe.py``'s requests (3 slots, cache 128), warms
the decode step up, then runs ``--steps`` greedy decode steps twice: once
timed on the host clock around a ``torch.cuda.synchronize()``, once under
``torch.profiler``.  Prints one JSON line with the wall and device
milliseconds per step, the device's busy share, the kernel launches per
step, the device kernels and the operators that take the most device
time, and the share of the device time spent in ``group_matmul``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.bench import golden
from repro_torch.models import lm
from repro_torch.serve.steps import make_decode_step, make_prefill_step

#: the serving depth cuts of ``chip_smoke.py`` (the 41.9 B parameters of
#: Phi-3.5-MoE do not fit the card's 80 GB in bf16); other configs whole
DEPTH = {"phi35_moe_42b": 4}
SLOTS, CACHE_LEN = 3, 128


def serve_config(arch: str):
    """``arch`` at full width with its serving depth cut, if any."""
    name = configs.ALIASES.get(arch, arch)
    cfg = configs.get_arch(name)
    if name in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[name])
    return cfg


def decode_profile(cfg, device, steps: int) -> dict:
    """Profile ``steps`` decode steps of ``cfg`` on ``device``."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = golden.first_wave_tokens(SLOTS, dev)
    plen = toks.shape[1]
    decode = make_decode_step(cfg)
    with torch.inference_mode():
        last, caches = make_prefill_step(cfg, CACHE_LEN)(params, toks)
        nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        pos = plen

        def run(n):
            nonlocal nxt, caches, pos
            for _ in range(n):
                nxt, caches = decode(params, caches, nxt, pos)
                pos += 1
            sync()

        run(3)                                   # warm-up
        t0 = time.perf_counter()
        run(steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            run(steps)
    return dict(
        device=(torch.cuda.get_device_name(0) if cuda else "cpu"),
        arch=cfg.name, n_layers=cfg.n_layers, slots=SLOTS, steps=steps,
        wall_ms_per_step=wall_ms, **device_summary(prof, steps, wall_ms))


def device_summary(prof, steps: int, wall_ms: float) -> dict:
    """Device milliseconds a step, the busy share of ``wall_ms``, the share
    in ``group_matmul``, kernel launches a step and the top kernels and
    operators of a ``torch.profiler`` run over ``steps`` steps."""
    avgs = prof.key_averages()
    on_device = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0) or 0.0

    # a kernel's time is in its own (device) event and again in the self
    # device time of the operator that launched it: sum the device events
    # for the total, rank kernels and operators separately
    kern = [e for e in avgs if e.device_type == on_device]
    device_us = sum(dev_us(e) for e in kern)
    gm_us = sum(dev_us(e) for e in kern if "group_matmul" in e.key)
    launches = sum(1 for e in prof.events() if e.device_type == on_device)
    ops = [e for e in avgs if e.device_type != on_device]

    def top(events, n=8):
        return [dict(name=e.key[:80], us_per_step=dev_us(e) / steps,
                     calls_per_step=e.count / steps)
                for e in sorted(events, key=dev_us, reverse=True)[:n]]

    return dict(
        device_ms_per_step=device_us / 1e3 / steps,
        device_busy_share=(device_us / 1e3 / steps) / wall_ms,
        group_matmul_device_share=gm_us / max(device_us, 1e-9),
        kernel_launches_per_step=launches / steps,
        top_kernels=top(kern), top_device_ops=top(ops))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3.5-moe-42b-a6.6b")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    out = decode_profile(serve_config(ns.arch), ns.device, ns.steps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
