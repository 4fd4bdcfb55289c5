"""The dry run held to a real step, and its counter's rule for DTensors.

    from repro_torch.bench import dryrun_check
    dryrun_check.real_vs_fake(cfg, slots=4, cache_len=512, device="cuda")

:func:`real_vs_fake` runs one greedy decode step of ``cfg`` on real
tensors under :class:`repro_torch.launch.roofline.Counter` (on the card
the expert products launch the ``group_matmul`` kernel) and the same step
on fake tensors through :func:`repro_torch.launch.dryrun.count_step`;
the two counts of FLOPs and eager bytes must be equal.  It then times
the real step with CUDA events and sets the time beside the step's
roofline bound at the H100 constants.  :func:`dispatch_us` is the host
time a call of the ``repro_torch::group_matmul`` operator adds over its
implementation called directly.  :func:`skip_rule_probe` is the
product of two sharded matrices on a 512-rank ``fake`` group whose
per-rank count the tests pin (1,048,576 FLOPs, and a 2,048-byte
all-gather for the redistribution after it), run on any torch the port
meets.
"""
from __future__ import annotations

import statistics

import torch

from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.models import lm
from repro_torch.serve.steps import make_decode_step


def real_vs_fake(cfg, *, slots: int, cache_len: int, device="cuda",
                 seed: int = 0, reps: int = 10) -> dict:
    """One decode step of ``cfg`` (``slots`` x 1 tokens against a cache of
    ``cache_len``) counted on real tensors and on fake ones, with the
    real step's median CUDA-event milliseconds over ``reps`` steps (None
    off the card) and the roofline terms of its count."""
    from repro_torch.kernels.group_matmul import group_matmul
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(cfg, gen)
    caches = lm.make_caches(cfg, slots, cache_len, device=dev)
    tokens = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                           dtype=torch.int32, device=dev)
    step = make_decode_step(cfg)
    launches0 = group_matmul.launches
    with torch.no_grad():
        with rl.Counter() as real:
            step(params, caches, tokens, 0)
        launches = group_matmul.launches - launches0
        ms = None
        if dev.type == "cuda":
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(params, caches, tokens, 0)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
    del params, caches
    fake, _, fake_s = dryrun.count_step(cfg, "decode", cache_len, slots, None,
                                        device=device)
    terms = rl.RooflineTerms(flops=real.flops, hbm_bytes=real.bytes,
                             coll_bytes=0, coll_breakdown={}, chips=1,
                             model_flops=rl.model_flops(cfg, cache_len,
                                                        slots, "decode"))
    bound_ms = terms.bound_time * 1e3
    return dict(
        real_flops=real.flops, fake_flops=fake.flops,
        real_bytes=real.bytes, fake_bytes=fake.bytes,
        real_ops=real.ops, fake_ops=fake.ops,
        flops_by_op=real.flops_by_op,
        group_matmul_launches=launches, group_matmul_flops=(
            real.flops_by_op.get("repro_torch.group_matmul", 0)),
        step_ms=ms, t_compute_ms=terms.t_compute * 1e3,
        t_memory_ms=terms.t_memory * 1e3, bound_ms=bound_ms,
        dominant=terms.dominant,
        bound_share=None if ms is None else bound_ms / ms,
        fake_s=fake_s)


def skip_rule_probe(device="cuda") -> dict:
    """x (64, 1024) split over (pod, data) times w (1024, 4096) split over
    model on a 2 x 16 x 16 mesh of 512 fake ranks, then the product
    gathered over model, each under the counter; returns rank 0's FLOPs
    of the product and the collective payload of the gather."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    kind = torch.device(device).type
    dryrun.fake_world(512)
    try:
        mesh = dryrun.device_mesh(16, 16, kind, pod=2)
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(64, 1024, device=kind), mesh,
                                  [Shard(0), Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(1024, 4096, device=kind), mesh,
                                  [Replicate(), Replicate(), Shard(1)])
            with rl.Counter() as product:
                y = x @ w
            with rl.Counter() as gather:
                z = y.redistribute(mesh, [Shard(0), Shard(0), Replicate()])
            local = tuple(z.to_local().shape)
    finally:
        dist.destroy_process_group()
    return dict(product_flops=product.flops,
                product_collectives=product.collective_total,
                gather_flops=gather.flops,
                gather_bytes=dict(gather.collective_bytes),
                gathered_local_shape=local)


def dispatch_us(device="cuda", calls: int = 2000) -> dict:
    """Wall microseconds a call of ``group_matmul`` through the operator
    (the wrapper's checks, the dispatcher and ``custom_op``'s layer) and
    of the operator's implementation called directly, on one 8-row tile
    so small that the host, not the kernel, sets the pace."""
    import importlib
    import time
    gm = importlib.import_module("repro_torch.kernels.group_matmul")
    dev = torch.device(device)
    impl = gm._group_matmul_cuda if dev.type == "cuda" else \
        gm._group_matmul_op._init_fn
    x = torch.ones((8, 64), device=dev)
    w = torch.ones((1, 64, 64), device=dev)
    eid = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = {}
    with torch.inference_mode():
        for name, fn in (("operator", lambda: gm.group_matmul(
                x, eid, w, tile_m=8)), ("implementation",
                                        lambda: impl(x, eid, w, 8))):
            for _ in range(100):
                fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[f"{name}_us"] = (time.perf_counter() - t0) / calls * 1e6
    out["added_us"] = out["operator_us"] - out["implementation_us"]
    return out
