"""Run every benchmark: one section per paper table or figure, plus the
hand-written kernels' legs and the roofline table from the dry run's
records.

The port of the reference's ``benchmarks/run.py``: the same ten sections,
``--only`` and ``--force``; a section that raises is reported and the run
ends with exit code 1.  The ``kernels`` section runs
:func:`repro_torch.bench.kernels.main`, so a full run launches the three
CUDA kernels (``bcsr_spmm``, ``sddmm``, ``group_matmul``) and holds each
to its plain version.

    PYTHONPATH=src python -m repro_torch.bench.run            # all, on the card
    PYTHONPATH=src python -m repro_torch.bench.run --only fig11,fig13
    PYTHONPATH=src python -m repro_torch.bench.run --device cpu
"""
from __future__ import annotations

import argparse
import time
import traceback

SECTIONS = [
    ("harness", "shared simulator runs (all workloads x architectures)"),
    ("fig11", "performance vs baselines + in-network %"),
    ("fig12", "performance-per-watt"),
    ("fig13", "fabric utilization"),
    ("fig14", "network congestion"),
    ("fig16", "bandwidth vs sparsity tradeoff"),
    ("fig17", "scaling with array size"),
    ("table2", "throughput & power efficiency"),
    ("kernels", "CUDA kernel legs against their plain versions"),
    ("roofline", "dry-run roofline table"),
]


def _section(name: str, table, *, force: bool, device):
    """Run one section; returns the harness table when it built one."""
    from repro_torch.bench import (fig11_performance, fig12_perf_watt,
                                   fig13_utilization, fig14_congestion,
                                   fig16_bandwidth, fig17, harness, kernels,
                                   roofline, table2_efficiency)
    if name == "harness":
        table = harness.run_all(force=force, verbose=False, device=device)
        print(f"(cached: {len(table)} workloads x up to 5 archs)")
        return table
    figures = {"fig11": fig11_performance, "fig12": fig12_perf_watt,
               "fig13": fig13_utilization, "fig14": fig14_congestion,
               "table2": table2_efficiency}
    if name in figures:
        figures[name].main(table)
    elif name == "fig16":
        fig16_bandwidth.main()
    elif name == "fig17":
        fig17.main(force=force, device=device)
    elif name == "kernels":
        print(kernels.main(device=device))
    elif name == "roofline":
        roofline.main()
    return table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated section names")
    ap.add_argument("--force", action="store_true",
                    help="re-run simulations instead of using the cache")
    ap.add_argument("--device", default="cuda",
                    help="the simulator's and the kernels' device")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    table = None
    failures = []
    for name, desc in SECTIONS:
        if only and name not in only and name != "harness":
            continue
        t0 = time.time()
        print(f"\n### {name} — {desc}\n")
        try:
            table = _section(name, table, force=args.force,
                             device=args.device)
        except Exception as e:  # noqa: BLE001
            failures.append((name, e))
            traceback.print_exc()
        print(f"[{name}: {time.time()-t0:.1f}s]")

    print("\n" + "=" * 78)
    if failures:
        print(f"FAILED sections: {[n for n, _ in failures]}")
        raise SystemExit(1)
    print("all benchmark sections completed")


if __name__ == "__main__":
    main()
