"""``python -m repro_torch.analysis.lint`` — audit benchmark workloads.

Compiles every benchmark workload (``repro_torch.bench.workloads.make_all``)
onto each mesh of the fig17 geometry grid, runs the full static check
battery on each (workload, geometry) cell, and prints a findings table
with the static cost estimate per cell.  Exit status is non-zero when
any error or warning finding survives (info findings — e.g. "capacity
is only provable dynamically" for BFS/SSSP — are reported but pass).

CI runs this as a fast-tier zero-findings gate: the benchmark suite is
the corpus of known-good programs, so any finding here is either a
compiler regression or an analysis false positive — both are bugs.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any

SIZES = [(2, 2), (4, 4), (8, 8)]


def _build(wl: Any, width: int, height: int, strategy: str) -> Any:
    """Compile one benchmark workload onto a (width x height) mesh."""
    from repro_torch.core.machine import MachineConfig

    mem = int(wl.mem_words)
    while True:
        cfg = MachineConfig(width=width, height=height, mem_words=mem)
        try:
            return wl.build(cfg, strategy)
        except MemoryError:
            # Small meshes concentrate rows; grow per-PE memory like the
            # benchmark harnesses do.
            if mem >= (1 << 18):
                raise
            mem *= 2


def run_lint(sizes: list[tuple[int, int]] | None = None,
             strategy: str = "dissimilarity", verbose: bool = False,
             out=sys.stdout) -> int:
    from repro_torch.bench.workloads import make_all
    from repro_torch.analysis.checks import check_workload
    from repro_torch.analysis.cost import cost_report

    sizes = sizes or SIZES
    wls = make_all()
    header = (f"{'workload':<12} {'geom':<6} {'err':>4} {'warn':>5} "
              f"{'info':>5} {'est_cycles':>11}  notes")
    print(header, file=out)
    print("-" * len(header), file=out)
    n_err = n_warn = 0
    for wl in wls:
        for (w, h) in sizes:
            try:
                compiled = _build(wl, w, h, strategy)
            except Exception as e:  # compile failure is a finding too
                n_err += 1
                print(f"{wl.name:<12} {w}x{h:<4} {'-':>4} {'-':>5} {'-':>5} "
                      f"{'-':>11}  BUILD FAILED: {e}", file=out)
                continue
            findings = check_workload(compiled)
            errs = [f for f in findings if f.severity == "error"]
            warns = [f for f in findings if f.severity == "warn"]
            infos = [f for f in findings if f.severity == "info"]
            n_err += len(errs)
            n_warn += len(warns)
            rep = cost_report(compiled)
            note = ""
            if rep["dynamic"]:
                note = "dynamic"
            if errs or warns:
                note = (note + " " if note else "") + str(errs[0] if errs
                                                          else warns[0])
            print(f"{wl.name:<12} {w}x{h:<4} {len(errs):>4} "
                  f"{len(warns):>5} {len(infos):>5} "
                  f"{rep['estimate_cycles']:>11.0f}  {note}", file=out)
            if verbose:
                for f in findings:
                    print(f"    {f}", file=out)
    print(file=out)
    if n_err or n_warn:
        print(f"LINT: FAIL ({n_err} error(s), {n_warn} warning(s))",
              file=out)
        return 1
    print(f"LINT: OK ({len(wls)} workloads x {len(sizes)} geometries, "
          "0 findings above info)", file=out)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint", description=__doc__)
    ap.add_argument("--sizes", default=None,
                    help="comma-separated WxH list (default: 2x2,4x4,8x8)")
    ap.add_argument("--strategy", default="dissimilarity",
                    help="partition strategy to compile with")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every finding, not just counts")
    ns = ap.parse_args(argv)
    sizes = None
    if ns.sizes:
        sizes = [(int(w), int(h)) for w, h in
                 (tok.lower().split("x") for tok in ns.sizes.split(","))]
    return run_lint(sizes=sizes, strategy=ns.strategy, verbose=ns.verbose)


if __name__ == "__main__":
    raise SystemExit(main())
