"""The multi-device slice's legs: the lane split and the AM dispatch over
the shards of a list of devices, each held to its reference.

* :func:`run_shard` — the legs of ``golden/shard.json`` (the reference's
  ``sweep(..., shard=True)`` under four forced host devices: ``grid``,
  ``odd``, ``cap``, ``pack``) over four shards, each held to its record
  bit for bit (lanes, shard plan, packing, per-shard telemetry) and to
  its workloads' oracles, with its wall, each engine call's ticks per
  shard and the engine cache's size; then a ``SweepService`` of 4
  super-lanes over two shards on ``fig17_traffic(copies=1)``, every lane
  held to ``golden/service.json``.
* :func:`run_dispatch` — ``spmv_sharded`` over 8 shards of an n x n
  power-law matrix (``repro_torch.launch.sparse_dispatch``'s generator)
  against float64 ``a @ x`` within 1e-3, plain and with stealing at the
  worst bucket's capacity; then ``psum_compressed`` over 4 shards of
  seeded f32 gradients of the ``repro-100m`` parameter tree's shapes,
  each shard's sum held to the float64 sum of the dequantized payloads
  (within 1e-6 of the sum of the terms' magnitudes: f32 adds 4 terms to
  within 3 x 2^-24 of it) and each shard's error feedback to
  ``compress_tree``'s bit for bit.

``chip_smoke.py`` runs both on logical shards of one card.  On a host
with four cards this module also compares the two layouts in turns
(logical shards of ``cuda:0``, the four cards, the four cards, logical
shards), one JSON line a turn:

    python -m repro_torch.bench.multidevice            # needs 4 cards

Any failed check raises.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from repro_torch.bench import fig17, golden, serve_bench
from repro_torch.core import machine
from repro_torch.core.sweep import SweepRequest, sweep
from repro_torch.launch import sparse_dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train_100m import CFG_100M
from repro_torch.models import lm
from repro_torch.serve import SweepService
from repro_torch.sparse import dispatch as am
from repro_torch.train import compress
from repro_torch.train.optimizer import tree_leaves, tree_map

#: ``spmv_sharded``'s matrix size on the card
DISPATCH_N = 8192
#: shards of the ``psum_compressed`` leg, and its bound relative to the
#: sum of the terms' magnitudes
PSUM_SHARDS = 4
PSUM_TOL = 1e-6
#: the sharded service leg: super-lanes, shards, chunk, traffic copies
SHARD_SERVICE = dict(n_supers=4, shards=2, chunk=64, copies=1)


def sync(devs) -> None:
    """Wait for every CUDA device of ``devs``."""
    for dev in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


class EngineCalls:
    """Wraps ``machine._get_engine`` so that the engines it hands out keep
    the outputs ``(st, over, idle, ticks)`` of every call in
    ``self.outs`` (lists with an entry per shard from a sharded
    engine) and, given ``timed_on`` (devices), each call's seconds in
    ``self.seconds``, the devices synchronised before and after it.  As a
    context manager it installs itself for the block."""

    def __init__(self, timed_on=None):
        self.inner, self.outs, self.seconds = machine._get_engine, [], []
        self.timed_on = timed_on

    def __call__(self, *args, **kw):
        engine = self.inner(*args, **kw)

        def run(*a):
            if self.timed_on:
                sync(self.timed_on)
                t0 = time.perf_counter()
            out = engine(*a)
            if self.timed_on:
                sync(self.timed_on)
                self.seconds.append(time.perf_counter() - t0)
            self.outs.append(out)
            return out
        return run

    def __enter__(self):
        machine._get_engine = self
        return self

    def __exit__(self, *exc):
        machine._get_engine = self.inner


def run_shard(devs: list, service_devs: list, *, tag: str = "[shard]",
              verbose: bool = True) -> dict:
    """The sharded legs over ``devs`` (four devices, which may repeat) and
    the sharded service over ``service_devs`` (:data:`SHARD_SERVICE`'s
    two shards), each held to its golden record.  Returns a row per
    leg."""
    want = golden.load_shard_golden()
    devs = make_host_mesh(golden.SHARD_DEVICES, 1,
                          devices=devs).devices_along("data")
    rows = {}
    for name in golden.SHARD_LEGS:
        cfg, kw, keys = golden.port_shard_leg(name)
        machine.clear_engine_cache()
        rec = EngineCalls()
        machine._get_engine = rec
        sync(devs)
        t0 = time.time()
        try:
            report = sweep(cfg, SweepRequest(**kw), device=devs[0],
                           devices=devs)
        finally:
            machine._get_engine = rec.inner
        sync(devs)
        wall = time.time() - t0
        golden.check_shard(golden.shard_record(name, keys, report),
                           want[name])
        for key, wl, r in zip(keys, kw["workloads"], report):
            if not (r.completed and wl.check(r.mem_val)):
                raise AssertionError(f"{tag} {name} {key}: WRONG RESULT")
        if machine.engine_cache_size() != 1:
            raise AssertionError(f"{tag} {name} built "
                                 f"{machine.engine_cache_size()} engines")
        rows[name] = dict(
            lanes=len(keys), wall_s=wall,
            ticks_per_shard=[[int(t[0]) for t in (
                o[3] if isinstance(o[3], list) else [o[3]])]
                for o in rec.outs],
            engine_cache_size=machine.engine_cache_size(),
            shard=report.shard.to_json(),
            stepped_pe_ticks=report.telemetry.stepped_pe_ticks)
        if verbose:
            print(f"{tag} {name}: {len(keys)} lanes over "
                  f"{report.shard.n_devices} shards of "
                  f"{sorted({str(d) for d in devs})} match the golden "
                  f"records; {json.dumps(rows[name])}", flush=True)
    svc_want = golden.load_service_golden()["lanes"]
    spec = SHARD_SERVICE
    keys = golden.service_lane_keys(fig17.SIZES, copies=spec["copies"])
    cfg, lanes = serve_bench.fig17_traffic(spec["copies"])
    machine.clear_engine_cache()
    sync(service_devs)
    t0 = time.time()
    with SweepService(cfg, template=lanes, n_supers=spec["n_supers"],
                      chunk=spec["chunk"], slice_chunks=1, shard=True,
                      devices=service_devs, device=service_devs[0]) as svc:
        futs = [svc.submit(w) for w in lanes]
        svc.drain(timeout=600)
        got = {k: golden.lane_record(f.result(timeout=5))
               for k, f in zip(keys, futs)}
        stats = dict(svc.stats)
        n_dev = svc._n_dev
    wall = time.time() - t0
    golden.check_lanes(got, {k: svc_want[k] for k in keys})
    if n_dev != spec["shards"] or machine.engine_cache_size() != 1:
        raise AssertionError(f"{tag} service on {n_dev} shards, "
                             f"{machine.engine_cache_size()} engines")
    rows["service"] = dict(
        lanes=len(lanes), shards=n_dev, wall_s=wall,
        engine_cache_size=machine.engine_cache_size(),
        **{k: stats[k] for k in ("n_slices", "engine_ticks", "n_refills",
                                 "stepped_pe_ticks", "plain_pe_ticks")})
    if verbose:
        print(f"{tag} service: {len(lanes)} lanes of fig17_traffic(copies="
              f"{spec['copies']}) on {spec['n_supers']} super-lanes over "
              f"{n_dev} shards of {sorted({str(d) for d in service_devs})} "
              f"match the golden records; {json.dumps(rows['service'])}",
              flush=True)
    return rows


def run_dispatch(spmv_devs: list, psum_devs: list, *, n: int = DISPATCH_N,
                 psum_cfg=CFG_100M, tag: str = "[dispatch]",
                 verbose: bool = True) -> dict:
    """``spmv_sharded`` over the 8 shards of ``spmv_devs`` on an ``n`` x
    ``n`` power-law matrix against float64 ``a @ x`` (plain, and with
    stealing at the worst bucket's capacity), then ``psum_compressed``
    over the 4 shards of ``psum_devs`` on the gradient shapes of
    ``psum_cfg``'s parameters against the float64 sum of the dequantized
    payloads and ``compress_tree``'s errors."""
    n_sh = sparse_dispatch.N_SHARDS
    mesh = make_host_mesh(n_sh, 1, devices=spmv_devs)
    devs = mesh.devices_along("data")
    rng = np.random.default_rng(3)
    t0 = time.time()
    a = sparse_dispatch.powerlaw_sparse(n, n, rng)
    x = rng.standard_normal(n).astype(np.float32)
    shards = am.shard_csr_rows(a, n_sh)
    want = a.astype(np.float64) @ x
    setup_s = time.time() - t0
    xs = n // n_sh
    worst = max(int(np.bincount(shards["col"][s, :shards["nnz"][s]] // xs,
                                minlength=n_sh).max()) for s in range(n_sh))
    cap = int(shards["cap"])
    legs = {}
    for label, kw in (("plain", {}),
                      ("opportunistic", dict(capacity=max(worst, 1),
                                             opportunistic=True))):
        am.spmv_sharded(mesh, shards, x, **kw)           # warm-up
        sync(devs)
        t1 = time.time()
        y = am.spmv_sharded(mesh, shards, x, **kw)
        wall_ms = (time.time() - t1) * 1e3
        err = float(np.abs(y - want).max())
        if y.shape != want.shape or not err < sparse_dispatch.TOL:
            raise AssertionError(f"{tag} spmv_sharded {label}: max |err| "
                                 f"{err} over {sparse_dispatch.TOL}")
        c = kw.get("capacity", cap)
        # the tiled all-to-alls: (val, off, valid) out, the product back,
        # 4 bytes each, S x S x capacity slots (and the psum'd histogram)
        moved = n_sh * n_sh * c * 16 + (n_sh * n_sh * 4 if kw else 0)
        legs[label] = dict(capacity=c, max_abs_err=err, wall_ms=wall_ms,
                           all_to_all_bytes=moved)
    spmv = dict(n=n, shards=n_sh, nnz=int(shards["nnz"].sum()), cap=cap,
                worst_bucket=worst, setup_s=setup_s, **legs)
    if verbose:
        print(f"{tag} spmv_sharded over {n_sh} shards of "
              f"{sorted({str(d) for d in devs})} within "
              f"{sparse_dispatch.TOL} of float64 a @ x; {json.dumps(spmv)}",
              flush=True)

    pmesh = make_host_mesh(PSUM_SHARDS, 1, devices=psum_devs)
    pdevs = pmesh.devices_along("data")
    gen = torch.Generator(device=pdevs[0]).manual_seed(0)
    with torch.no_grad():
        shapes = lm.init_params(psum_cfg, gen, dtype=torch.float32).tree()
        grads, errors = [], []
        for dev in pdevs:
            g = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                               device=pdevs[0]), shapes)
            e = tree_map(lambda p: torch.randn(
                p.shape, generator=gen, device=pdevs[0]) * 1e-3, shapes)
            grads.append(tree_map(lambda t, d=dev: t.to(d), g))
            errors.append(tree_map(lambda t, d=dev: t.to(d), e))
    del shapes
    compress.psum_compressed(grads, errors, mesh=pmesh, axis="data")
    sync(pdevs)
    t1 = time.time()
    summed, new_err = compress.psum_compressed(grads, errors, mesh=pmesh,
                                               axis="data")
    sync(pdevs)
    psum_ms = (time.time() - t1) * 1e3
    packs = [compress.compress_tree(g, e) for g, e in zip(grads, errors)]
    numel = sum(p.numel() for p in tree_leaves(grads[0]))
    worst_rel = max_err = 0.0
    for i, _ in enumerate(tree_leaves(summed[0])):
        terms = [compress.dequantize(tree_leaves(p)[i],
                                     tree_leaves(sc)[i]).double().to(pdevs[0])
                 for p, sc, _ in packs]
        exact = sum(terms)
        scale = sum(t.abs() for t in terms).clamp(min=1e-30)
        for s in range(PSUM_SHARDS):
            diff = (tree_leaves(summed[s])[i].double().to(pdevs[0])
                    - exact).abs()
            max_err = max(max_err, float(diff.max()))
            worst_rel = max(worst_rel, float((diff / scale).max()))
    if not worst_rel <= PSUM_TOL:
        raise AssertionError(f"{tag} psum_compressed: an error of "
                             f"{worst_rel} of the terms' magnitudes")
    for s, (_, _, err) in enumerate(packs):
        for got, ref in zip(tree_leaves(new_err[s]), tree_leaves(err)):
            if not torch.equal(got, ref):
                raise AssertionError(f"{tag} psum_compressed: an error "
                                     "feedback differs from compress_tree's")
    n_leaves = len(tree_leaves(grads[0]))
    psum = dict(shards=PSUM_SHARDS, leaves=n_leaves, numel=numel,
                max_abs_err=max_err, max_err_over_magnitudes=worst_rel,
                wall_ms=psum_ms,
                int8_payload_bytes=PSUM_SHARDS * (numel + 4 * n_leaves),
                psum_copy_bytes=PSUM_SHARDS * PSUM_SHARDS * 4 * numel)
    if verbose:
        print(f"{tag} psum_compressed over {PSUM_SHARDS} shards of "
              f"{sorted({str(d) for d in pdevs})}: sums and error feedback "
              f"held; {json.dumps(psum)}", flush=True)
    del grads, errors, summed, new_err, packs
    return dict(spmv=spmv, psum=psum)


def main() -> int:
    if torch.cuda.device_count() < 4:
        raise SystemExit(f"multidevice: needs 4 cards, found "
                         f"{torch.cuda.device_count()}")
    cards = [torch.device("cuda", i) for i in range(4)]
    logical = [cards[0]] * 4
    for i, (name, devs) in enumerate((("logical", logical), ("cards", cards),
                                      ("cards", cards),
                                      ("logical", logical))):
        t0 = time.time()
        shard = run_shard(devs, devs[:2], tag=f"[{name}]", verbose=False)
        t1 = time.time()
        disp = run_dispatch(devs * 2, devs, tag=f"[{name}]", verbose=False)
        print(json.dumps(dict(
            turn=i, layout=name, shard_s=t1 - t0,
            dispatch_s=time.time() - t1,
            legs_wall_s={k: v["wall_s"] for k, v in shard.items()},
            ticks_per_shard={k: v.get("ticks_per_shard")
                             for k, v in shard.items()},
            spmv_ms={k: disp["spmv"][k]["wall_ms"]
                     for k in ("plain", "opportunistic")},
            spmv_max_abs_err=disp["spmv"]["plain"]["max_abs_err"],
            psum_ms=disp["psum"]["wall_ms"],
            psum_max_err_over_magnitudes=disp["psum"][
                "max_err_over_magnitudes"])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
