"""Chaos soak: seeded faults against the sweep service, gated — a port of
the reference's ``benchmarks/chaos_soak.py``.

Drives the oversubscribed fig17-smoke traffic
(:func:`repro_torch.bench.serve_bench.fig17_traffic`) through
:func:`repro_torch.serve.chaos.run_soak` with a seeded fault schedule
(transient faults retried with backoff + a scheduler kill/restart
absorbed by drain), one deadline-exceeded lane, duplicate submissions
and a checkpoint every two slices — then restores from a mid-soak
checkpoint and replays the in-flight tail.  Everything is gated on
bit-identity:

  * every surviving lane's RunResult == the one-shot ``run_many`` of
    the same lanes (metrics AND memory image);
  * the deadline lane fails ONLY its own future, frozen exactly at the
    deadline, with per-PE diagnostics + telemetry attached;
  * the restored service's outcomes == the original soak's, bit for bit;
  * with ``golden`` (the records of ``golden/service.json``), every one
    of those results also equals the JAX reference's record, and the
    deadline lane its ``run_many(deadlines=[d])`` record.

Any violation lands in ``record["failures"]``; ``main`` prints them and
exits nonzero.  The reference's persistent XLA compile-cache knobs have
no counterpart here: torch compiles nothing.

    PYTHONPATH=src python -m repro_torch.bench.chaos_soak --seed 5

(Any seed must pass.)  It runs on the card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from repro_torch.core import machine


def run(seed: int, *, copies: int = 2, n_transients: int = 2,
        n_kills: int = 1, chunk: int = 8, timeout: float = 900.0,
        verbose: bool = True, golden: dict | None = None,
        device="cuda") -> dict:
    """One gated soak + restore round on ``device``; returns the result
    record (``record["failures"]`` empty iff the gate passes)."""
    from repro_torch.bench.golden import lane_record
    from repro_torch.bench.serve_bench import fig17_traffic
    from repro_torch.checkpoint.store import list_steps
    from repro_torch.serve import DeadlineError, FaultSchedule, SweepService
    from repro_torch.serve.chaos import results_bit_identical, run_soak

    failures: list[str] = []
    want = None if golden is None else list(golden["lanes"].values())

    def held(r, lane: int, what: str) -> None:
        """``r`` against the in-run reference and the golden record."""
        if not results_bit_identical(r, reference[lane]):
            failures.append(f"{what} drifted from one-shot run_many")
        if want is not None and lane_record(r) != want[lane]:
            failures.append(f"{what} differs from the golden record")

    cfg, lanes = fig17_traffic(copies)
    t0 = time.perf_counter()
    reference = machine.run_many(cfg, lanes, device=device)
    reference_s = time.perf_counter() - t0
    if want is not None:
        if len(want) != len(lanes):
            failures.append(f"golden holds {len(want)} lanes, the traffic "
                            f"{len(lanes)}")
        for i, r in enumerate(reference):
            if lane_record(r) != want[i]:
                failures.append(f"one-shot run_many lane {i} differs from "
                                "the golden record")
    dl_lane = max(range(len(reference)), key=lambda i: reference[i].cycles)
    deadline = max(1, reference[dl_lane].cycles // 2)
    if golden is not None and (golden["deadline"]["lane"],
                               golden["deadline"]["cycles"]) != (dl_lane,
                                                                 deadline):
        failures.append(f"deadline lane {dl_lane} at {deadline} cycles, "
                        f"golden has {golden['deadline']}")

    # checkpoints go to a temporary directory, removed with everything
    # in it once the restore has run
    with tempfile.TemporaryDirectory(prefix="chaos-soak-") as root:
        schedule = FaultSchedule.seeded(
            seed, n_transients=n_transients, n_kills=n_kills,
            horizon=4 * (n_transients + n_kills))
        t0 = time.perf_counter()
        report, svc = run_soak(
            cfg, lanes, seed=seed, schedule=schedule,
            deadline_lane=dl_lane, deadline_cycles=deadline,
            duplicates=max(1, len(lanes) // 4), timeout=timeout,
            service_kwargs=dict(template=lanes, n_supers=2, chunk=chunk,
                                slice_chunks=1, checkpoint_root=root,
                                checkpoint_every=2,
                                checkpoint_keep=10_000),
            device=device)
        svc.shutdown()
        soak_s = time.perf_counter() - t0

        fired_kinds = sorted({k for _, _, k in report.fired})
        if "transient" not in fired_kinds or "kill" not in fired_kinds:
            failures.append(f"schedule under-fired: {report.fired} "
                            "(raise --copies or lower --chunk so slices "
                            "outnumber the horizon)")
        if report.stats["n_restarts"] < n_kills:
            failures.append(f"restarts {report.stats['n_restarts']} < "
                            f"injected kills {n_kills}")

        expect_survivors = set(range(len(lanes))) - {dl_lane}
        if set(report.survivors) != expect_survivors:
            failures.append(f"survivor set {sorted(report.survivors)} != "
                            f"{sorted(expect_survivors)}")
        for i, r in report.survivors.items():
            held(r, i, f"lane {i}")
        for i, r in report.duplicate_results.items():
            held(r, i, f"duplicate of lane {i}")

        def deadline_ok(err, what: str) -> None:
            if err.result is None or err.result.cycles != deadline:
                failures.append(f"{what} froze at "
                                f"{err.result and err.result.cycles}, "
                                f"expected exactly {deadline}")
            elif (golden is not None and lane_record(err.result)
                  != golden["deadline"]["record"]):
                failures.append(f"{what} differs from the golden "
                                "run_many(deadlines=[d]) record")

        err = report.results[dl_lane]
        if not isinstance(err, DeadlineError):
            failures.append(f"deadline lane {dl_lane} got "
                            f"{type(err).__name__}, expected "
                            "DeadlineError")
        else:
            deadline_ok(err, "deadline lane")
            if err.telemetry is None:
                failures.append("deadline error carries no telemetry")

        # restore from a mid-soak checkpoint: the in-flight tail must
        # land on the same bits
        steps = list_steps(root)
        restored_lanes = 0
        restore_s = 0.0
        if not steps:
            failures.append("soak wrote no checkpoints")
        else:
            t0 = time.perf_counter()
            svc2 = SweepService.restore(
                cfg, root, step=steps[len(steps) // 2], device=device)
            try:
                futs = svc2.futures
                if not futs:
                    failures.append("the mid-soak checkpoint held no "
                                    "in-flight lanes")
                svc2.drain(timeout=timeout)
                for seq, f in futs.items():
                    lane = report.seq_lane[seq]
                    restored_lanes += 1
                    try:
                        r = f.result(timeout=10)
                    except DeadlineError as e:
                        if lane != dl_lane:
                            failures.append(f"restored lane {lane} bad "
                                            "deadline outcome")
                        else:
                            deadline_ok(e, "restored deadline lane")
                    except Exception as e:  # noqa: BLE001 — report all
                        failures.append(f"restored lane {lane} failed: "
                                        f"{e}")
                    else:
                        held(r, lane, f"restored lane {lane}")
            finally:
                svc2.shutdown()
            restore_s = time.perf_counter() - t0

    record = dict(
        seed=seed, n_lanes=len(lanes), chunk=chunk, device=str(device),
        deadline_lane=dl_lane, deadline_cycles=deadline,
        fired=[list(f) for f in report.fired],
        n_slices=report.stats["n_slices"],
        engine_ticks=report.stats["engine_ticks"],
        n_retries=report.stats["n_retries"],
        n_restarts=report.stats["n_restarts"],
        n_checkpoints=report.stats["n_checkpoints"],
        n_deadline_failures=report.stats["n_deadline_failures"],
        refill_occupancy=(report.stats["occupancy_sum"]
                          / max(1, report.stats["n_slices"])),
        dead_step_fraction=report.telemetry.dead_step_fraction,
        restored_lanes=restored_lanes,
        restored_from_step=steps[len(steps) // 2] if steps else None,
        reference_s=reference_s, soak_s=soak_s, restore_s=restore_s,
        failures=failures)
    if verbose:
        print(json.dumps(record, indent=2))
    return record


def main() -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos soak of the sweep service, "
                    "bit-identity gated")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-schedule + traffic-order seed")
    ap.add_argument("--copies", type=int, default=2,
                    help="fig17-smoke traffic copies (oversubscription)")
    ap.add_argument("--transients", type=int, default=2)
    ap.add_argument("--kills", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=8,
                    help="engine chunk: smaller => more slices => more "
                         "fault-landing opportunities")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    record = run(args.seed, copies=args.copies,
                 n_transients=args.transients, n_kills=args.kills,
                 chunk=args.chunk, timeout=args.timeout, device=args.device)
    if record["failures"]:
        print(f"CHAOS SOAK FAILED ({len(record['failures'])} violation(s))",
              file=sys.stderr)
        return 1
    print("chaos soak passed: every surviving lane bit-identical, "
          "deadline + restore exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
