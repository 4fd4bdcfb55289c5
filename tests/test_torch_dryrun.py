"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's on the CPU.

The reference's ``repro/launch/dryrun.py`` is never imported: its first
lines force 512 XLA host devices on the whole process.  Its
``TRAIN_POLICY`` and record layout are read from the file with ``ast``,
and its inputs are built from ``repro.train.step.synth_batch`` and
``repro.models.lm.make_caches`` directly, as its ``input_specs`` does.

* ``input_specs`` and ``lm.shape_params`` give the reference's shapes
  and dtypes leaf by leaf for every runnable cell (the port's layers
  unstacked: a layer leaf is the stacked leaf without its layer axis);
* two cells run whole on the fake process group, each a record in the
  reference's layout plus ``sources``: Minitron-4B's ``decode_32k`` on
  the 16 x 16 mesh of 256 ranks, with the 1- and 2-layer pair, whose
  ``reconstruct_pair`` equals the full depth's count exactly (the port's
  layer loop is Python, so no loop body is counted once), and Zamba2's
  ``long_500k`` on the 2 x 16 x 16 mesh of 512 ranks, its caches at the
  ``long_context`` placement (the sequence over ``data`` and ``model``);
* no process group outlives a ``run_cell``;
* the command line runs one cell to ``OK`` and exit code 0.
"""
import ast
import os
import subprocess
import sys

import jax
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.train.step import synth_batch as ref_synth_batch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import dryrun_check  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF_DRYRUN = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


def _ref_record_keys() -> tuple:
    """The keys of the reference's record (``lower_cell``'s ``rec =
    dict(...)``) and of its ``memory``."""
    tree = ast.parse(open(REF_DRYRUN).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "rec":
            keys = {k.arg for k in node.value.keywords}
            mem = next(k.value for k in node.value.keywords
                       if k.arg == "memory")
            return keys, {k.arg for k in mem.keywords}
    raise AssertionError("no record in the reference's dry run")


def _leaves(tree, path=()):
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _ref_leaf(tree, path):
    for k in path:
        if not isinstance(k, int):
            tree = tree[k]
    return tree


def _same_leaves(port_tree, ref_tree, *, stacked: bool):
    """Every port leaf has its reference leaf's shape (with the layer axis
    where ``stacked`` and the port's path holds a layer index) and dtype;
    both trees hold the same named leaves."""
    seen = set()
    for path, x in _leaves(port_tree):
        want = _ref_leaf(ref_tree, path)
        shape = tuple(x.shape)
        if stacked and any(isinstance(k, int) for k in path):
            shape = (None,) + shape
            assert tuple(want.shape)[1:] == shape[1:], (path, want.shape,
                                                        x.shape)
        else:
            assert tuple(want.shape) == shape, (path, want.shape, x.shape)
        assert x.dtype == _DTYPES[str(want.dtype)], (path, x.dtype,
                                                     want.dtype)
        seen.add(tuple(k for k in path if not isinstance(k, int)))
    ref_paths = {tuple(k.key for k in kp) for kp, _ in
                 jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert seen == ref_paths


def _runnable():
    return [(a, s) for a, s, ok, _ in configs.cells() if ok]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shape_params_equal_the_reference(arch):
    port = lm.shape_params(configs.get_arch(arch), device="cpu")
    ref = ref_lm.shape_params(ref_configs.get_arch(arch))
    _same_leaves(port, ref, stacked=True)
    for path, x in _leaves(port):
        assert x.device.type == "cpu"
        want = _ref_leaf(ref, path)
        if any(isinstance(k, int) for k in path):
            assert len([k for k in path if isinstance(k, int)]) == 1
            n = len(port[path[0]])
            assert tuple(want.shape)[0] == n, (path, want.shape, n)


@pytest.mark.parametrize("arch,shape_id", _runnable())
def test_input_specs_equal_the_reference(arch, shape_id):
    cfg = configs.get_arch(arch)
    rcfg = ref_configs.get_arch(arch)
    seq, batch, kind = configs.SHAPES[shape_id]
    with FakeTensorMode():
        port, got_kind = dryrun.input_specs(cfg, shape_id, device="cpu")
    assert got_kind == kind
    if kind == "train":
        ref = {"batch": jax.eval_shape(
            lambda: ref_synth_batch(rcfg, batch, seq))}
    elif kind == "prefill":
        if rcfg.frontend == "audio":
            ref = {"frames": jax.ShapeDtypeStruct((batch, seq, 512),
                                                  jax.numpy.bfloat16)}
        else:
            ref = {"tokens": jax.ShapeDtypeStruct((batch, seq),
                                                  jax.numpy.int32)}
            if rcfg.frontend == "vision":
                ref["patches"] = jax.ShapeDtypeStruct(
                    (batch, rcfg.n_patches, rcfg.d_frontend),
                    jax.numpy.bfloat16)
    else:
        ref = {"caches": jax.eval_shape(
                   lambda: ref_lm.make_caches(rcfg, batch, seq)),
               "tokens": jax.ShapeDtypeStruct((batch, 1), jax.numpy.int32),
               "index": jax.ShapeDtypeStruct((), jax.numpy.int32)}
    _same_leaves(port, ref, stacked=False)


def _check_record(rec, *, arch, shape_id, mesh, chips):
    keys, mem_keys = _ref_record_keys()
    assert set(rec) >= keys | {"model_flops", "sources"}
    assert set(rec["memory"]) == mem_keys
    assert set(rec["collective_bytes"]) == set(rl.COLLECTIVE_KEYS)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        (arch, shape_id, mesh, chips)
    assert rec["hlo_bytes"] is None
    assert rec["flops_reported"] > 0 and rec["bytes_reported"] > 0
    assert rec["collective_total"] == sum(rec["collective_bytes"].values())
    for k in ("argument_bytes", "output_bytes", "temp_bytes",
              "alias_bytes"):
        assert rec["memory"][k] > 0, k
    for k in keys - {"arch", "shape", "kind", "mesh", "chips", "seq",
                     "batch", "policy", "memory"}:
        assert k in rec["sources"], k
    seq, batch, kind = configs.SHAPES[shape_id]
    assert rec["model_flops"] == rl.model_flops(configs.get_arch(arch), seq,
                                                batch, kind)


def test_decode_cell_on_256_fake_ranks_with_its_layer_pair():
    import torch.distributed as dist
    rec = dryrun.run_cell("minitron_4b", "decode_32k", False, pair=True,
                          save=False, device="cpu")
    assert not dist.is_initialized()
    _check_record(rec, arch="minitron_4b", shape_id="decode_32k",
                  mesh="16x16", chips=256)
    assert rec["policy"]["n_layers"] == 32
    assert rec["sources"]["caches"] == "cache_specs(long_context=False)"
    # every layer is counted: the pair rebuilds the full depth exactly
    assert rec["flops_corrected"] == rec["flops_reported"]
    assert rec["bytes_corrected"] == rec["bytes_reported"]
    assert rec["coll_corrected"] == rec["collective_total"]
    assert set(rec["pair"]) == {"1", "2"}
    # the cache (sequence over 'model') and the gathered weights: 32
    # layers of (128 / 16 rows) x 8 KV heads x 32768 x 128, k and v, bf16
    kv = 32 * 2 * (128 // 16) * 8 * (32768 // 16) * 128 * 2
    assert rec["memory"]["alias_bytes"] == kv


def test_long_cell_on_512_fake_ranks_takes_the_long_context_placement():
    import torch.distributed as dist
    rec = dryrun.run_cell("zamba2_1p2b", "long_500k", True, save=False,
                          device="cpu")
    assert not dist.is_initialized()
    _check_record(rec, arch="zamba2_1p2b", shape_id="long_500k",
                  mesh="2x16x16", chips=512)
    assert rec["kind"] == "long" and rec["batch"] == 1
    assert rec["sources"]["caches"].startswith(
        "cache_specs(long_context=True)")
    cfg = configs.get_arch("zamba2_1p2b")
    # the shared attention's caches: 524288 positions over data x model
    # (256 ways), batch whole; n_apps x (k, v) x n_kv x hd, bf16
    n_apps = cfg.n_layers // cfg.ssm.attn_every
    kv = n_apps * 2 * cfg.n_kv * (524288 // 256) * cfg.hd * 2
    assert rec["memory"]["alias_bytes"] >= kv


@pytest.mark.parametrize("long_context", [False, True])
def test_zero_caches_are_placed_as_place_caches_places(long_context):
    """``lm.make_caches(mesh=, long_context=)`` builds each rank's zero
    shard where ``place_caches`` puts a whole cache's: the same
    placements and local shapes, on the 2 x 16 x 16 mesh of 512 fake
    ranks (a batch of one with ``long_context``, else one per batch
    shard)."""
    from repro_torch.distributed import sharding as shd
    cfg = configs.get_arch("zamba2_1p2b").reduced()
    b = 1 if long_context else 32
    with dryrun.production_mesh(True, "cpu") as mesh, FakeTensorMode():
        made = lm.make_caches(cfg, b, 1024, device="cpu", mesh=mesh,
                              long_context=long_context)
        placed = shd.place_caches(lm.make_caches(cfg, b, 1024, device="cpu"),
                                  mesh, long_context=long_context)
        got = [(p, x.placements, x.to_local().shape, x.shape)
               for p, x in _leaves(made)]
        want = [(p, x.placements, x.to_local().shape, x.shape)
                for p, x in _leaves(placed)]
    assert got == want
    # the shared attention's keys: (apps, batch, kv heads, 1024, hd), the
    # sequence over 'model' (16 ways) or over 'data' and 'model' (256)
    k = dict((p, local) for p, _, local, _ in got)[("shared_attn", "k")]
    assert k[3] == (1024 // 256 if long_context else 1024 // 16)


def test_real_step_counts_as_the_fake_one():
    """A real decode step of the reduced Phi-3.5-MoE (the expert products
    through the plain version on the CPU) counts exactly the FLOPs and
    eager bytes of the same step on fake tensors; the card does the same
    at full width with the kernel (``chip_smoke.py``'s ``[dryrun]``)."""
    cfg = configs.get_arch("phi35_moe_42b").reduced()
    got = dryrun_check.real_vs_fake(cfg, slots=4, cache_len=64,
                                    device="cpu")
    assert got["real_flops"] == got["fake_flops"] > 0
    assert got["real_bytes"] == got["fake_bytes"] > 0
    assert got["real_ops"] == got["fake_ops"]
    # three expert products a layer, each one operator
    assert got["group_matmul_flops"] > 0
    assert got["step_ms"] is None and got["bound_ms"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_token_walking_steps_are_quadratic_in_length(kind):
    """The xLSTM walks its sequence token by token, so the dry run counts
    its long cells at three short lengths and extrapolates: the
    polynomial through them gives a fourth length's counts exactly."""
    cfg = configs.get_arch("xlstm_350m").reduced()
    assert dryrun.walks_tokens(cfg, kind)
    fit = dryrun.fit_counts(cfg, kind, 40, 2, None, device="cpu",
                            seqs=(8, 16, 24))
    got = dryrun._counts(*dryrun.count_step(cfg, kind, 40, 2, None,
                                            device="cpu"))
    for key in ("flops", "bytes", "collective_bytes", "flops_by_op"):
        assert fit[key] == got[key], key
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert fit["memory"][key] == got["memory"][key], key
    assert fit["seq_fit"] == [8, 16, 24]


def test_cli_runs_one_cell():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--mesh", "single",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK   xlstm_350m x decode_32k x single" in out.stdout
    assert "done; failures=0" in out.stdout
    path = os.path.join(dryrun.OUT_DIR, "xlstm_350m__decode_32k__single.json")
    assert os.path.exists(path)
