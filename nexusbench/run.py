"""Run one cell of the benchmark once and print its result line.

    python3 nexusbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``compared`` last: the
numbers the check compared, each with its limit).  The same numbers are
the last lines of standard error.  Without a CUDA card, or with fewer
than the cell asks for, it prints no result and exits 2; if JAX or the
JAX package was loaded, it exits 3.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# one process, few threads; every cache inside the checkout
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "2")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ["USE_FLAX"] = "0"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from nexusbench import harness
    bench = harness.load_benchmark()
    chips = harness.cell(args.workload, bench).chips

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print("loaded JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    lines = [f"{k} {v['value']} (limit {v['limit']})"
             for k, v in out["compared"].items()]
    print("compared: " + "; ".join(lines), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
