"""Multi-pod dry run: every (arch x shape) cell's step, counted per rank
on a fake process group (the port of the reference's
``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --all --mesh both [--device cpu]
    python -m repro_torch.launch.dryrun --arch phi3.5-moe-42b-a6.6b \\
        --shape decode_32k --mesh single --pair

The reference lowers and compiles each cell with XLA over 256 or 512
forced host devices and reads the compiled program's cost and memory
analyses.  Here each cell runs once, eagerly, on fake tensors
(``FakeTensorMode``: shapes and dtypes, nothing allocated) over a
``fake`` process group of 256 (16 x 16 ``("data", "model")``) or 512
(2 x 16 x 16 ``("pod", "data", "model")``) ranks, of which this process
is rank 0.  The parameters, optimizer state, batch and caches are
``DTensor``s at the placements of ``repro_torch.distributed.sharding``,
and the step is the port's own (``make_train_step``, the prefill, encode
and decode steps under ``mesh=``).  :class:`repro_torch.launch.roofline
.Counter` counts rank 0's local ops: FLOPs, eager bytes, collective
payload and the peak of its temporary storage.  Nothing is compiled, so
the record's ``compile_s`` is the fake run's wall seconds and
``hlo_bytes`` is None; ``sources`` names where each number comes from.

The process group is made and destroyed inside :func:`run_cell`: nothing
of it outlives the call.  Records go to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import fractions
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import lm
from repro_torch.serve.steps import (encode_step, make_decode_step,
                                     make_prefill_step)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import make_train_step, synth_batch

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# Per-arch distribution policy (training) — the baseline the perf loop
# iterates on.  (remat, seq_shard_acts, microbatch)
TRAIN_POLICY = {
    "mistral_large_123b": ("full", True, 4),
    "minitron_8b": ("dots", True, 1),
    "minitron_4b": ("dots", False, 1),
    "stablelm_3b": ("dots", False, 1),
    "zamba2_1p2b": ("dots", False, 1),
    "xlstm_350m": ("dots", False, 1),
    "hubert_xlarge": ("dots", False, 1),
    "phi35_moe_42b": ("full", True, 2),
    "deepseek_v2_lite_16b": ("dots", True, 1),
    "llava_next_mistral_7b": ("dots", True, 1),
}

#: where each number of a record comes from
SOURCES = {
    "flops_reported": "roofline.Counter: torch.utils.flop_counter formulas "
                      "over rank 0's local ops (ops on DTensors and DTensor's "
                      "metadata propagation skipped); repro_torch::"
                      "group_matmul is one op of 2*t*d*f",
    "bytes_reported": "roofline.Counter: eager bytes, the tensor operands "
                      "read and results written by every local op that moves "
                      "data (no views, no allocations); no fusion, so not "
                      "XLA's bytes accessed",
    "collective_bytes": "roofline.Counter: local operand bytes of the "
                        "_c10d_functional collectives on rank 0",
    "collective_total": "the sum of collective_bytes",
    "compile_s": "wall seconds of the fake run (nothing is compiled)",
    "hlo_bytes": "none: eager PyTorch has no HLO",
    "memory.argument_bytes": "local shards of the step's inputs",
    "memory.output_bytes": "local shards of the step's outputs",
    "memory.alias_bytes": "local shards of the inputs updated in place "
                          "(parameters and optimizer state, or caches)",
    "memory.temp_bytes": "roofline.Counter: high-water mark of the local "
                         "storage allocated during the step (live storage "
                         "less the arguments)",
    "model_flops": "roofline.model_flops (analytic)",
}


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in a tree of dicts, lists,
    tuples and ``LM`` modules (each storage counted once)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if hasattr(x, "tree"):
            walk(x.tree())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            t = x.to_local() if dctx.is_sharded(x) else x
            key = id(t.untyped_storage())
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    walk(tree)
    return total


def input_specs(cfg, shape_id: str, device="cuda"):
    """Fake stand-ins for every model input of this cell (call it under a
    ``FakeTensorMode``): the train batch of ``synth_batch``, the prefill's
    tokens (and patches) or frames, or the decode step's caches, token
    and 0-dim int32 index."""
    seq, batch, kind = configs.SHAPES[shape_id]
    return _inputs(cfg, kind, seq, batch, device), kind


def _inputs(cfg, kind: str, seq: int, batch: int, device) -> dict:
    if kind == "train":
        gen = torch.Generator(device=device)
        return {"batch": synth_batch(cfg, batch, seq, gen)}
    if kind == "prefill":
        if cfg.frontend == "audio":
            toks = torch.empty((batch, seq, 512), dtype=torch.bfloat16,
                               device=device)
            return {"frames": toks}
        toks = torch.empty((batch, seq), dtype=torch.int32, device=device)
        extra = {}
        if cfg.frontend == "vision":
            extra["patches"] = torch.empty(
                (batch, cfg.n_patches, cfg.d_frontend), dtype=torch.bfloat16,
                device=device)
        return {"tokens": toks, **extra}
    # decode / long: one new token against a seq-long cache
    caches = lm.make_caches(cfg, batch, seq, device=device)
    toks = torch.empty((batch, 1), dtype=torch.int32, device=device)
    idx = torch.empty((), dtype=torch.int32, device=device)
    return {"caches": caches, "tokens": toks, "index": idx}


def _vision_prefill(cfg, seq: int):
    """The VLM's prefill as the reference lowers it: the patches and the
    tokens into a cache of ``seq + n_patches``; the last position's
    logits and the caches."""
    def step(params, tokens, patches):
        mesh = tokens.device_mesh if dctx.is_sharded(tokens) else None
        caches = lm.make_caches(cfg, tokens.shape[0], seq + cfg.n_patches,
                                device=tokens.device, mesh=mesh)
        logits, caches, _ = lm.forward(
            params, cfg, {"tokens": tokens, "patches": patches},
            caches=caches, cache_index=0)
        return logits[:, -1, :], caches
    return step


def _cell_config(arch_id, policy, n_layers_override, microbatch_override,
                 arch_overrides, unroll):
    cfg = configs.get_arch(arch_id)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    remat, seqshard, microbatch = policy or TRAIN_POLICY.get(
        arch_id, ("dots", False, 1))
    if microbatch_override is not None:
        microbatch = microbatch_override
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
        if cfg.ssm is not None:
            cfg = dataclasses.replace(
                cfg, ssm=dataclasses.replace(cfg.ssm, attn_every=max(
                    1, min(cfg.ssm.attn_every, cfg.n_layers))))
    cfg = dataclasses.replace(cfg, remat=remat, seq_shard_acts=seqshard,
                              unroll_layers=unroll)
    return cfg, (remat, seqshard, microbatch)


def count_step(cfg, kind: str, seq: int, batch: int, mesh=None, *,
               microbatch: int = 1, device="cuda"):
    """One step of ``kind`` (train, prefill, decode or long) of ``cfg`` at
    ``seq`` x ``batch``, run once on fake tensors under a
    :class:`roofline.Counter`, on ``mesh`` (a named ``DeviceMesh`` over an
    initialised process group) or, with None, on one rank with no mesh.
    Returns ``(counter, memory, wall_s)``: the counter after the step,
    the record's ``memory`` dict and the fake run's wall seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    params = lm.shape_params(cfg, device=device, fake_mode=fake)
    long_ctx = kind == "long"
    counter = rl.Counter()
    t0 = time.time()
    with fake:
        if mesh is not None:
            params = shd.place_params(params, mesh)

        def on_batch(x):
            if mesh is None:
                return x
            return shd.place(x, shd.batch_sharding(mesh, x.shape))

        inputs = _inputs(cfg, kind, seq, batch, device)
        if kind == "train":
            state = adamw_init(params.tree())
            bt = {k: on_batch(v) for k, v in inputs["batch"].items()}
            step = make_train_step(cfg, microbatch=microbatch)
            args = (params, state, bt)
            alias = (params, state)
            grad = contextlib.nullcontext()
        elif kind == "prefill":
            if cfg.encoder_only:
                step = encode_step(cfg)
                args = (params, on_batch(inputs["frames"]))
            elif cfg.frontend == "vision":
                step = _vision_prefill(cfg, seq)
                args = (params, on_batch(inputs["tokens"]),
                        on_batch(inputs["patches"]))
            else:
                step = make_prefill_step(cfg, cache_len=seq)
                args = (params, on_batch(inputs["tokens"]))
            alias = ()
            grad = torch.no_grad()
        else:  # decode / long
            caches = inputs["caches"]
            toks = inputs["tokens"]
            if mesh is not None:
                caches = lm.make_caches(cfg, batch, seq, device=device,
                                        mesh=mesh, long_context=long_ctx)
                toks = shd.place(toks, shd.named(
                    shd.P(None, None), mesh) if long_ctx else
                    shd.batch_sharding(mesh, toks.shape))
            step = make_decode_step(cfg)
            # the position is a host int in the port's step; it moves no
            # count (attention masks the whole cache by length)
            args = (params, caches, toks, 0)
            alias = (caches,)
            grad = torch.no_grad()
        arg_bytes = _local_bytes(args) + (
            inputs["index"].nbytes if "index" in inputs else 0)
        with grad, dctx.use_mesh(mesh), counter:
            out = step(*args)
        memory = dict(argument_bytes=arg_bytes, output_bytes=_local_bytes(out),
                      temp_bytes=counter.peak_bytes,
                      alias_bytes=_local_bytes(alias))
    return counter, memory, time.time() - t0


def fit_seqs(cfg) -> tuple:
    """The lengths a step that walks its sequence one token at a time
    (:func:`walks_tokens`) is run at: with attention (the Zamba2 hybrid's
    shared block), multiples of its 256-query blocks past one block, so
    that every length takes the same code path; else any three."""
    return (64, 128, 192) if cfg.xlstm else (512, 768, 1024)


def walks_tokens(cfg, kind: str) -> bool:
    """Whether the step runs a Python step per token: the xLSTM's
    recurrences, and the Mamba-2 layers given a cache (the prefill).  A
    fake op costs about a hundred microseconds on the host, so 32,768
    tokens take hours; such a cell is counted by :func:`fit_counts`."""
    return kind in ("train", "prefill") and (
        cfg.xlstm or (cfg.ssm is not None and kind == "prefill"))


def _at(xs, ys, x):
    """The polynomial of degree ``len(xs) - 1`` through ``(xs, ys)`` at
    ``x`` (Lagrange, in exact fractions); an int when it is whole."""
    total = fractions.Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = fractions.Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= fractions.Fraction(x - xj, xi - xj)
        total += term
    return int(total) if total.denominator == 1 else float(total)


def _counts(counter, memory, wall_s) -> dict:
    return dict(flops=counter.flops, bytes=counter.bytes,
                collective_bytes=dict(counter.collective_bytes),
                flops_by_op=dict(counter.flops_by_op), memory=memory,
                wall_s=wall_s, seq_fit=None)


def fit_counts(cfg, kind: str, seq: int, batch: int, mesh=None, *,
               microbatch: int = 1, device="cuda", seqs=None) -> dict:
    """The counts of :func:`count_step` at ``seq``, from runs at the
    lengths ``seqs`` and the polynomial through them (degree 2 for three
    lengths).  Each count of such a step is a polynomial of degree at
    most 2 in the length: attention over a cache of the prompt's length
    is quadratic, the recurrences, products and collectives linear, so
    three lengths fix it (``tests/test_torch_dryrun.py`` holds a fourth
    length of the reduced xLSTM's steps to it exactly).  ``temp_bytes`` is the same polynomial's
    value, an estimate: a peak need not be polynomial.  ``seqs``
    defaults to :func:`fit_seqs`."""
    seqs = tuple(seqs or fit_seqs(cfg))
    runs = [_counts(*count_step(cfg, kind, s, batch, mesh,
                                microbatch=microbatch, device=device))
            for s in seqs]

    def fit(get):
        return _at(seqs, [get(r) for r in runs], seq)
    ops = sorted({k for r in runs for k in r["flops_by_op"]})
    return dict(
        flops=fit(lambda r: r["flops"]), bytes=fit(lambda r: r["bytes"]),
        collective_bytes={k: fit(lambda r: r["collective_bytes"][k])
                          for k in runs[0]["collective_bytes"]},
        flops_by_op={k: fit(lambda r: r["flops_by_op"].get(k, 0))
                     for k in ops},
        memory={k: fit(lambda r: r["memory"][k]) for k in runs[0]["memory"]},
        wall_s=sum(r["wall_s"] for r in runs), seq_fit=list(seqs))


def lower_cell(arch_id: str, shape_id: str, mesh, *, policy=None,
               unroll: bool = False, n_layers_override: int | None = None,
               microbatch_override: int | None = None,
               arch_overrides: dict | None = None, device="cuda"):
    """Run one (arch x shape) cell's step once on fake tensors under the
    counter (:func:`count_step`; a step that walks its sequence token by
    token at three shorter lengths, :func:`fit_counts`), on ``mesh`` (None:
    one rank, no mesh).  Returns the record.

    ``unroll`` is kept for the reference's record: the port's layer loop
    is Python, so every layer is counted whether or not it is set."""
    cfg, (remat, seqshard, microbatch) = _cell_config(
        arch_id, policy, n_layers_override, microbatch_override,
        arch_overrides, unroll)
    seq, batch, kind = configs.SHAPES[shape_id]
    if walks_tokens(cfg, kind) and seq > fit_seqs(cfg)[-1]:
        got = fit_counts(cfg, kind, seq, batch, mesh, microbatch=microbatch,
                         device=device)
    else:
        got = _counts(*count_step(cfg, kind, seq, batch, mesh,
                                  microbatch=microbatch, device=device))
    chips = mesh.size() if mesh is not None else 1
    shape = tuple(mesh.shape) if mesh is not None else (1,)
    caches = None
    if kind in ("decode", "long"):
        caches = ("cache_specs(long_context=True): batch whole, sequence "
                  "over (data, model); tokens replicated" if kind == "long"
                  else "cache_specs(long_context=False)")
    sources = dict(SOURCES, caches=caches, seq_fit=None)
    if got["seq_fit"] is not None:
        sources["seq_fit"] = (
            f"the step walks its {seq} tokens one at a time: every count "
            f"is the degree-2 polynomial through its runs at "
            f"{got['seq_fit']} tokens (exact but temp_bytes, an estimate); "
            f"compile_s is their wall seconds")
    return dict(
        arch=arch_id, shape=shape_id, kind=kind,
        mesh="x".join(str(v) for v in shape),
        chips=chips,
        seq=seq, batch=batch,
        policy=dict(remat=remat, seq_shard_acts=seqshard,
                    microbatch=microbatch, unroll=unroll,
                    n_layers=cfg.n_layers),
        flops_reported=float(got["flops"]),
        bytes_reported=float(got["bytes"]),
        collective_bytes=got["collective_bytes"],
        collective_total=float(sum(got["collective_bytes"].values())),
        compile_s=got["wall_s"],
        hlo_bytes=None,
        memory=got["memory"],
        flops_by_op=got["flops_by_op"],
        sources=sources,
    )


def _fake_backend(common_opts, backend_opts):
    """c10d's ``FakeProcessGroup`` (no communication: each collective
    returns at once), for the rank and size c10d hands over."""
    from torch._C._distributed_c10d import FakeProcessGroup
    make = getattr(FakeProcessGroup, "_create_internal", None)
    if make is not None:
        return make(common_opts.group_rank, common_opts.group_size,
                    backend_opts)
    return FakeProcessGroup(common_opts.group_rank, common_opts.group_size)


def fake_world(size: int):
    """Initialise the default process group as rank 0 of ``size`` fake
    ranks (nothing is communicated)."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the dry "
                           "run makes its own")
    if "FAKE" not in getattr(dist.Backend, "_plugins", {}):
        dist.Backend.register_backend("fake", _fake_backend,
                                      extended_api=True,
                                      devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=size)


@contextlib.contextmanager
def production_mesh(multi_pod: bool, device="cuda"):
    """The production mesh on a fake process group: 16 x 16 ``("data",
    "model")`` over 256 ranks, or 2 x 16 x 16 ``("pod", "data", "model")``
    over 512 with ``multi_pod``; the group is destroyed on exit."""
    import torch.distributed as dist
    fake_world(512 if multi_pod else 256)
    try:
        yield device_mesh(16, 16, torch.device(device).type,
                          pod=2 if multi_pod else None)
    finally:
        dist.destroy_process_group()


def run_cell(arch_id, shape_id, multi_pod: bool, *, pair: bool = False,
             save: bool = True, microbatch_override=None, policy=None,
             arch_overrides: dict | None = None, device="cuda"):
    with production_mesh(multi_pod, device) as mesh:
        rec = lower_cell(arch_id, shape_id, mesh,
                         microbatch_override=microbatch_override,
                         policy=policy, arch_overrides=arch_overrides,
                         device=device)
        cfg = configs.get_arch(arch_id)
        seq, batch, kind = configs.SHAPES[shape_id]
        rec["model_flops"] = rl.model_flops(cfg, seq, batch, kind)

        if pair:
            # 1-layer / 2-layer runs for the per-layer totals (the port's
            # layer loop is Python, so these equal the full-depth count for
            # a uniform stack; microbatch=1, flops are microbatch-invariant)
            recs = {}
            for nl in (1, 2):
                recs[nl] = lower_cell(
                    arch_id, shape_id, mesh, unroll=True,
                    n_layers_override=nl, microbatch_override=1,
                    policy=policy, arch_overrides=arch_overrides,
                    device=device)
            L = cfg.n_layers
            rec["flops_corrected"] = rl.reconstruct_pair(
                recs[1]["flops_reported"], recs[2]["flops_reported"], L)
            rec["bytes_corrected"] = rl.reconstruct_pair(
                recs[1]["bytes_reported"], recs[2]["bytes_reported"], L)
            rec["coll_corrected"] = rl.reconstruct_pair(
                recs[1]["collective_total"], recs[2]["collective_total"], L)
            rec["pair"] = {str(k): dict(
                flops=v["flops_reported"], bytes=v["bytes_reported"],
                coll=v["collective_total"]) for k, v in recs.items()}

    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        tag = f"{arch_id}__{shape_id}__{'multi' if multi_pod else 'single'}"
        with open(os.path.join(OUT_DIR, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _job(a: str, s: str, mp: bool, pair: bool, microbatch, device):
    """One cell of the command line: ``(record, None)`` or ``(None, the
    error and its traceback)``."""
    try:
        return run_cell(a, s, mp, pair=pair, microbatch_override=microbatch,
                        device=device), None
    except Exception as e:  # noqa: BLE001
        return None, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pair", action="store_true",
                    help="also run the 1L/2L roofline pair")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda or cpu)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    todo = []
    if args.all:
        for a, s, ok, why in configs.cells():
            if ok:
                todo.append((a, s))
            else:
                print(f"SKIP {a} x {s}: {why}")
    else:
        assert args.arch and args.shape
        a = configs.ALIASES.get(args.arch, args.arch)
        todo = [(a, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    jobs = [(a, s, mp, args.pair and not mp, args.microbatch, args.device)
            for a, s in todo for mp in meshes]
    failures = 0
    t_all = time.time()

    def report(job, rec, err, t0):
        nonlocal failures
        a, s, mp = job[:3]
        tag = f"{a} x {s} x {'multi' if mp else 'single'}"
        if err is None:
            print(f"OK   {tag}: compile={rec['compile_s']:.1f}s "
                  f"flops={rec['flops_reported']:.3g} "
                  f"coll={rec['collective_total']:.3g}B "
                  f"temp={rec['memory']['temp_bytes']} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        else:
            failures += 1
            print(f"FAIL {tag}: {err}", flush=True)

    if args.jobs <= 1:
        for job in jobs:
            t0 = time.time()
            report(job, *_job(*job), t0)
    else:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            futs = {pool.submit(_job, *job): job for job in jobs}
            for fut in concurrent.futures.as_completed(futs):
                report(futs[fut], *fut.result(), t_all)
    print(f"done; failures={failures} ({time.time() - t_all:.0f}s)")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
