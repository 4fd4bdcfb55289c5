"""Roofline table: reads the dry run's records under
``experiments/dryrun_torch/`` and prints the three-term analysis per
(arch x shape x mesh): compute / memory / collective seconds, the
dominant bottleneck, MODEL_FLOPS over counted FLOPs, and the roofline
fraction.

The port of the reference's ``benchmarks/roofline.py``, over the records
that :mod:`repro_torch.launch.dryrun` writes.  The terms are
:class:`repro_torch.launch.roofline.RooflineTerms` at H100 constants:
FLOPs are rank 0's counted ops (exact per rank: the port's layer loop is
Python, so no loop body is counted once and ``*_corrected`` equals the
full count), bytes are eager bytes (no fusion), and the link rate is an
assumption.

    PYTHONPATH=src python -m repro_torch.bench.roofline [--pattern '*'] [--breakdown]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import roofline as rl

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


def load_records(pattern: str = "*") -> list[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(DRYRUN_DIR,
                                           f"{pattern}.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def terms_of(rec: dict) -> rl.RooflineTerms:
    flops = rec.get("flops_corrected", rec["flops_reported"])
    byts = rec.get("bytes_corrected", rec["bytes_reported"])
    coll = rec.get("coll_corrected", rec["collective_total"])
    return rl.RooflineTerms(
        flops=flops, hbm_bytes=byts, coll_bytes=coll,
        coll_breakdown=rec["collective_bytes"], chips=rec["chips"],
        model_flops=rec["model_flops"])


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:7.2f}s "
    return f"{x*1e3:7.1f}ms"


def header() -> str:
    """The table's constants, from :mod:`repro_torch.launch.roofline`."""
    return (f"H100: {rl.PEAK_FLOPS / 1e12:.0f} TF/s bf16, "
            f"{rl.HBM_BW / 1e12:.2f} TB/s HBM, "
            f"{rl.ICI_BW / 1e9:.0f} GB/s link (assumed)")


def main(pattern: str = "*", *, show_breakdown: bool = False):
    recs = load_records(pattern)
    if not recs:
        print(f"no dry-run records match {pattern!r} under "
              f"{DRYRUN_DIR}: run `python -m repro_torch.launch.dryrun "
              f"--all --pair` first")
        return []
    print("=" * 100)
    print(f"Roofline — per (arch × shape × mesh); {header()}")
    print("=" * 100)
    print(f"{'arch':<22}{'shape':<13}{'mesh':<9}{'T_comp':>9}{'T_mem':>9}"
          f"{'T_coll':>9}  {'bound':<8}{'useful%':>8}{'roofl%':>8}"
          f"{'corr':>5}")
    rows = []
    for rec in recs:
        t = terms_of(rec)
        corrected = "y" if "flops_corrected" in rec else "n"
        print(f"{rec['arch']:<22}{rec['shape']:<13}{rec['mesh']:<9}"
              f"{fmt_s(t.t_compute)}{fmt_s(t.t_memory)}"
              f"{fmt_s(t.t_collective)}  {t.dominant:<8}"
              f"{100*t.useful_flops_frac:>7.1f}%"
              f"{100*t.mfu_bound:>7.1f}%{corrected:>5}")
        if show_breakdown:
            bd = rec["collective_bytes"]
            tot = max(sum(bd.values()), 1)
            parts = ", ".join(f"{k}={v/tot:.0%}" for k, v in bd.items()
                              if v > 0)
            print(f"{'':>44}collectives: {parts}")
        rows.append(dict(arch=rec["arch"], shape=rec["shape"],
                         mesh=rec["mesh"], **t.row()))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", default="*")
    ap.add_argument("--breakdown", action="store_true")
    a = ap.parse_args()
    main(a.pattern, show_breakdown=a.breakdown)
