"""Fault-tolerant training launcher: the port of the reference's
``repro/launch/train.py``.

    supervisor loop
      └── worker epoch: train_step over the data pipeline
            · step-atomic async checkpoints every --save-every steps
            · straggler watchdog: a step exceeding --step-timeout raises
            · on ANY worker failure: restore from the latest checkpoint and
              continue (or, with no checkpoint yet, restart from scratch)

Failure injection for tests and demos: ``--fail-at-step N`` raises inside
the host loop at step N exactly once, exercising the recovery path end to
end.  Everything runs on one device (``--device``, the card unless the
caller names another), or, with ``mesh=``, over a named ``DeviceMesh``
whose ranks the caller started: the parameters placed by
``param_shardings``, the optimizer state placed like them, the batch over
the batch axes, and a restore onto that mesh whatever mesh saved the
checkpoint (the reference's elastic restart).

    python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b
    python -m repro_torch.launch.train --arch stablelm-3b --device cpu
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import make_pipeline
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import rank_device
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.train.optimizer import AdamWState, adamw_init
from repro_torch.train.step import make_train_step


class WorkerFailure(RuntimeError):
    """A (simulated) worker crash or straggler timeout."""


@dataclasses.dataclass
class TrainLoopResult:
    steps_done: int
    final_loss: float
    restarts: int
    losses: list
    # per completed step, beside ``losses`` (the port's additions)
    aux_losses: list = dataclasses.field(default_factory=list)
    grad_norms: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)


def _build(cfg, lr, microbatch, device, params, mesh):
    """(params, AdamW state, step): a copy of the given parameters on
    ``device`` (the caller's stay as they are), or ``lm.init_params`` from
    a generator on ``device`` seeded with 0; on ``mesh``, placed there by
    ``param_shardings`` (each rank keeps a copy of its own slices)."""
    if params is None:
        params = lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    elif mesh is None:
        params = copy.deepcopy(params).to(device)
    if mesh is not None:
        params = shd.place_params(params, mesh)
    return params, adamw_init(params.tree()), make_train_step(
        cfg, lr=lr, microbatch=microbatch)


def _restore(mgr, params, opt, device, mesh):
    shardings = None
    if mesh is not None:
        ps = shd.param_shardings(params, mesh)
        shardings = (ps, AdamWState(m=ps, v=ps, master=ps, count=None))
    (tree, opt), step, extra = mgr.restore(
        (params.tree(), opt), device=device, shardings=shardings)
    return lm.LM(tree), opt, step, extra


def train(arch: str | ArchConfig, *, steps: int = 20, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, microbatch: int | None = None,
          ckpt_dir: str | None = None, save_every: int = 10,
          data_path: str | None = None, device="cuda", mesh=None,
          fail_at_step: int | None = None, step_timeout: float | None = None,
          max_restarts: int = 3, log_every: int = 5, reduced: bool = True,
          params: lm.LM | None = None) -> TrainLoopResult:
    """Supervised training with checkpoint/restart fault tolerance.

    ``mesh``: a named ``DeviceMesh`` (``data``, ``model``, and optionally
    ``pod``) over ranks the caller has started, each of which calls
    ``train`` alike.  As the reference's ``_build``, the parameters are
    placed by ``param_shardings`` and the optimizer state like them; the
    batch is split over the batch axes, a restore places every leaf on
    this mesh (whatever mesh saved it), and the mesh's first rank writes
    the checkpoints.  Every family trains on it (the frontend families
    take their frames or patches through ``make_train_step``, not this
    loop's token stream).  Without it everything runs on ``device``.

    Deviations from the reference:

    * ``device`` runs on one device where the reference builds a one-device
      mesh; under ``mesh`` it is that rank's device;
    * ``arch`` may also be an :class:`ArchConfig` (e.g. a depth-cut
      full-width config), to which ``reduced`` applies as to a name;
    * ``params`` starts from given parameters (an :class:`lm.LM`); by
      default they are ``lm.init_params`` in bf16 from a generator on
      ``device`` seeded with 0 (the reference draws its own from
      ``PRNGKey(0)``).  A restart from scratch starts from them again.
    """
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = configs.get_arch(configs.ALIASES.get(arch, arch))
    if reduced:
        cfg = cfg.reduced()
    if mesh is not None:
        device = rank_device(mesh)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None

    given = params
    params, opt, step_fn = _build(cfg, lr, microbatch, device, given, mesh)
    pipe = make_pipeline(cfg, batch, seq, path=data_path, prefetch=0)

    def to_device(x):
        x = torch.as_tensor(x, device=device)
        if mesh is None:
            return x
        return shd.place(x, shd.batch_sharding(mesh, x.shape))

    start = 0
    if mgr is not None and mgr.latest() is not None:
        params, opt, start, extra = _restore(mgr, params, opt, device, mesh)
        if "data" in extra:
            pipe.restore(extra["data"])
        print(f"[train] restored step {start}")

    res = TrainLoopResult(steps_done=start, final_loss=float("nan"),
                          restarts=0, losses=[])
    failed_once = False
    step_i = start
    while step_i < steps:
        try:
            while step_i < steps:
                t0 = time.time()
                if fail_at_step is not None and not failed_once \
                        and step_i == fail_at_step:
                    failed_once = True
                    raise WorkerFailure(f"injected failure at step {step_i}")
                b = {k: to_device(v) for k, v in next(pipe).items()}
                with dctx.use_mesh(mesh):
                    params, opt, metrics = step_fn(params, opt, b)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise WorkerFailure(f"non-finite loss at {step_i}")
                dt = time.time() - t0
                if step_timeout is not None and dt > step_timeout:
                    raise WorkerFailure(
                        f"straggler: step {step_i} took {dt:.1f}s "
                        f"> {step_timeout}s")
                res.losses.append(loss)
                res.aux_losses.append(float(metrics["aux_loss"]))
                res.grad_norms.append(float(metrics["grad_norm"]))
                res.step_s.append(dt)
                step_i += 1
                if log_every and step_i % log_every == 0:
                    print(f"[train] step {step_i}: loss={loss:.4f} "
                          f"({dt*1e3:.0f} ms)")
                if mgr is not None and step_i % save_every == 0:
                    mgr.save(step_i, (params.tree(), opt),
                             extra={"data": pipe.state()}, blocking=False)
        except WorkerFailure as e:
            res.restarts += 1
            print(f"[supervisor] worker failed: {e} "
                  f"(restart {res.restarts}/{max_restarts})")
            if res.restarts > max_restarts:
                raise
            if mgr is not None:
                mgr.wait()
                if mgr.latest() is not None:
                    params, opt, step_i, extra = _restore(mgr, params, opt,
                                                          device, mesh)
                    if "data" in extra:
                        pipe.restore(extra["data"])
                    print(f"[supervisor] resumed from step {step_i}")
                    continue
            # no checkpoint yet: restart from scratch
            params = opt = None
            params, opt, step_fn = _build(cfg, lr, microbatch, device, given,
                                          mesh)
            pipe = make_pipeline(cfg, batch, seq, path=data_path, prefetch=0)
            step_i = 0
    if mgr is not None:
        mgr.wait()
    res.steps_done = step_i
    res.final_loss = res.losses[-1] if res.losses else float("nan")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--step-timeout", type=float, default=None)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, microbatch=args.microbatch,
                ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                data_path=args.data, fail_at_step=args.fail_at_step,
                step_timeout=args.step_timeout, device=args.device,
                reduced=not args.full_size)
    print(json.dumps(dict(steps=res.steps_done, final_loss=res.final_loss,
                          restarts=res.restarts)))


if __name__ == "__main__":
    main()
