"""The port stands alone: it imports torch and numpy, never JAX and
nothing of the JAX package or the reference benchmarks, and its chip
smoke script refuses to run without a card."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|benchmarks)\b(?!_)"
    r"|from\s+(jax|repro|benchmarks)\b(?!_))", re.M)


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_imports_pull_in_no_jax_and_no_reference():
    """(f) a fresh interpreter imports every port module and the chip
    smoke script's helpers; neither jax nor any repro./benchmarks module
    is loaded."""
    mods = _port_modules()
    assert "repro_torch.core.machine" in mods
    assert "repro_torch.kernels.bcsr_spmm" in mods
    for m in ("repro_torch.kernels.group_matmul", "repro_torch.models.lm",
              "repro_torch.models.moe", "repro_torch.sparse.dispatch",
              "repro_torch.launch.serve", "repro_torch.serve.steps",
              "repro_torch.configs.phi35_moe_42b",
              "repro_torch.core.fastforward", "repro_torch.core.sweep",
              "repro_torch.analysis", "repro_torch.analysis.checks",
              "repro_torch.analysis.cost", "repro_torch.analysis.ir",
              "repro_torch.analysis.lint", "repro_torch.bench.fig17",
              "repro_torch.serve.fabric", "repro_torch.serve.chaos",
              "repro_torch.checkpoint", "repro_torch.checkpoint.store",
              "repro_torch.bench.serve_bench",
              "repro_torch.bench.chaos_soak", "repro_torch.data",
              "repro_torch.data.pipeline", "repro_torch.train",
              "repro_torch.train.optimizer", "repro_torch.train.step",
              "repro_torch.train.compress", "repro_torch.launch.train",
              "repro_torch.launch.train_100m", "repro_torch.convert",
              "repro_torch.bench.profile_train", "repro_torch.sparse",
              "repro_torch.sparse.formats", "repro_torch.sparse.ops",
              "repro_torch.testing", "repro_torch.launch.mesh",
              "repro_torch.launch.sparse_dispatch",
              "repro_torch.bench.multidevice", "repro_torch.distributed",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.context",
              "repro_torch.bench.harness",
              "repro_torch.bench.fig11_performance",
              "repro_torch.bench.fig12_perf_watt",
              "repro_torch.bench.fig13_utilization",
              "repro_torch.bench.fig14_congestion",
              "repro_torch.bench.table2_efficiency",
              "repro_torch.bench.fig16_bandwidth",
              "repro_torch.bench.hillclimb", "repro_torch.bench.roofline",
              "repro_torch.bench.run", "repro_torch.bench.bench_ci"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "harness = [m for m in sys.modules\n"
        "           if m.startswith('torch.testing._internal.distributed')]\n"
        "assert not harness, harness\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith(('repro.', 'benchmarks')))\n"
        "assert not bad, bad\n"
        "assert chip_smoke.main and chip_smoke.time_ms\n"
        "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout


def test_sources_have_no_forbidden_imports():
    """No import line of the port or the smoke script names jax, repro
    or benchmarks, and no module of the package names torch's test
    harness (``torch.testing._internal``, whose threaded process group
    only the tests and the smoke script use)."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            text = f.read()
        hits = FORBIDDEN.findall(text)
        assert not hits, (p, hits)
        if p.startswith(SRC):
            assert "torch.testing._internal" not in text, p


def test_no_function_defaults_to_the_cpu():
    """Every public function of the port that takes a ``device`` (or a
    mesh's ``device_type``) runs on the card unless its caller names
    another device: the parameter defaults to ``"cuda"`` or has no
    default."""
    import importlib
    import inspect
    seen = []
    for name in _port_modules():
        mod = importlib.import_module(name)
        for fname, fn in vars(mod).items():
            if fname.startswith("_") or not inspect.isfunction(fn) or \
                    fn.__module__ != name:
                continue
            params = inspect.signature(fn).parameters
            for key in ("device", "device_type"):
                p = params.get(key)
                if p is None:
                    continue
                seen.append(f"{name}.{fname}")
                assert p.default in ("cuda", inspect.Parameter.empty), \
                    (seen[-1], p.default)
    for f in ("repro_torch.models.layers.make_cache",
              "repro_torch.models.layers.rmsnorm_init",
              "repro_torch.models.layers.rope_freqs",
              "repro_torch.models.lm.make_caches",
              "repro_torch.models.mla.make_mla_cache",
              "repro_torch.models.mamba2.make_mamba_cache",
              "repro_torch.models.xlstm.make_mlstm_cache",
              "repro_torch.models.xlstm.make_slstm_cache",
              "repro_torch.launch.serve.serve_batch",
              "repro_torch.launch.train.train",
              "repro_torch.convert.tree_from_numpy",
              "repro_torch.convert.adamw_from_numpy",
              "repro_torch.core.machine.run_many",
              "repro_torch.core.machine.shard_devices",
              "repro_torch.core.sweep.sweep",
              "repro_torch.bench.fig17.run_grid_report",
              "repro_torch.bench.fig17.main",
              "repro_torch.bench.harness.run_grid_report",
              "repro_torch.bench.harness.run_all",
              "repro_torch.bench.fig16_bandwidth.simulate_sparsity_axis",
              "repro_torch.bench.hillclimb.fabric_autotune",
              "repro_torch.bench.bench_ci.run_smoke",
              "repro_torch.checkpoint.store.restore_checkpoint",
              "repro_torch.launch.mesh.device_mesh"):
        assert f in seen, f


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result,
    in the repository and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    env = dict(os.environ, PYTHONPATH="")
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=300, env=env, cwd=cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
