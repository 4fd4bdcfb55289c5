"""The port's training slice against the reference's on the CPU: the loss,
AdamW, the differentiable grouped expert product, the train step (with
microbatches and remat), the fault-tolerant ``train()`` loop and the
golden record the card's reduced training run is held to.

Every comparison with the reference uses the same f32 parameters
(``golden.serve_params_numpy``) and the same batches
(``SyntheticTokenStream``): ``jax.random`` cannot be reproduced in torch.
Tolerances, each from the port's measured distance to the reference:

* loss, aux loss, gradient norm: rtol 1e-5 (measured <= 6e-7 over 8
  steps; the sums run in other orders);
* parameters and f32 master weights: atol 5e-5, a sixth of one step of
  ``lr`` = 3e-4 (measured <= 2.7e-5): Adam's normalised step turns the
  last bits of a tiny gradient into a visible move;
* first and second moments: atol 1e-7 and 1e-8 (measured <= 1.6e-8 and
  6.1e-10).

Regenerate ``src/repro_torch/golden/train_reduced.json`` from the
reference with::

    PYTHONPATH=src:. python tests/test_torch_train.py
"""
import dataclasses
import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.train as ref_train  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models.layers import cross_entropy as ref_cross_entropy  # noqa: E402
from repro.train import compress as ref_compress  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import (adamw_from_numpy, adamw_to_numpy,  # noqa: E402
                                 params_from_numpy, params_to_numpy)
from repro_torch.data import SyntheticTokenStream  # noqa: E402
from repro_torch.kernels import group_matmul, grouped_expert_matmul  # noqa: E402
from repro_torch.launch import train_100m  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import cross_entropy  # noqa: E402
from repro_torch.train import compress  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.step import make_train_step, synth_batch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHI, STABLELM = "phi35_moe_42b", "stablelm_3b"
METRIC_RTOL = 1e-5
PARAM_ATOL, M_ATOL, V_ATOL = 5e-5, 1e-7, 1e-8


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.get_arch(arch).reduced(), **kw),
            dataclasses.replace(ref_configs.get_arch(arch).reduced(), **kw))


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, **tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w, np.float32),
                                   **tol)


@functools.lru_cache(maxsize=None)
def _ref_step(arch, microbatch):
    _, rcfg = _cfgs(arch)
    return jax.jit(ref_make_train_step(rcfg, lr=3e-4, microbatch=microbatch))


def _run_both(arch, steps, *, microbatch=None, seed=0, batch=4, seq=32):
    """``steps`` train steps of the reference and of the port from the same
    f32 parameters on the same batches: (ref params, ref state, ref
    metrics per step, port params, port state, port metrics per step)."""
    cfg, _ = _cfgs(arch)
    tree = golden.serve_params_numpy(cfg, seed)
    rp = jax.tree.map(jnp.asarray, tree)
    ro = ref_opt.adamw_init(rp)
    tp = params_from_numpy(tree, cfg, "cpu")
    to = opt.adamw_init(tp.tree())
    step = make_train_step(cfg, lr=3e-4, microbatch=microbatch)
    pipe = SyntheticTokenStream(cfg.vocab, batch, seq, seed=0)
    rms, tms = [], []
    for _ in range(steps):
        b = next(pipe)
        rp, ro, rm = _ref_step(arch, microbatch)(
            rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = step(tp, to, {k: torch.as_tensor(v)
                                   for k, v in b.items()})
        rms.append({k: float(v) for k, v in rm.items()})
        tms.append({k: float(v) for k, v in tm.items()})
    return rp, ro, rms, tp, to, tms


def _check_against_reference(run):
    rp, ro, rms, tp, to, tms = run
    for r, t in zip(rms, tms):
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(t[k], r[k], rtol=METRIC_RTOL,
                                       atol=1e-7 if k == "aux_loss" else 0)
    _close(params_to_numpy(tp), rp, rtol=1e-5, atol=PARAM_ATOL)
    got = adamw_to_numpy(to)
    assert got["count"] == int(ro.count) == len(rms)
    _close(got["master"], ro.master, rtol=1e-5, atol=PARAM_ATOL)
    _close(got["m"], ro.m, rtol=1e-4, atol=M_ATOL)
    _close(got["v"], ro.v, rtol=1e-4, atol=V_ATOL)


# ----------------------------------------------------------------- loss --
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                        None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if masked:   # an all-zero mask divides by one, not by zero
        zero = torch.zeros((3, 7))
        assert float(cross_entropy(torch.as_tensor(logits),
                                   torch.as_tensor(labels), zero)) == 0.0


# ------------------------------------------------------------ optimizer --
def test_adamw_update_matches_reference():
    """Three updates of a random tree (an f32 and a bf16 leaf, nested),
    the third clipped, against the reference's ``adamw_update``."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 3), "b": {"c": (4,), "d": (2, 6)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
    rp = jax.tree.map(jnp.asarray, params)
    rp["b"]["d"] = rp["b"]["d"].astype(jnp.bfloat16)
    tp = jax.tree.map(torch.as_tensor, params)
    tp["b"]["d"] = torch.as_tensor(np.asarray(rp["b"]["d"], np.float32)) \
        .bfloat16()
    ro, to = ref_opt.adamw_init(rp), opt.adamw_init(tp)
    for k, gscale in enumerate([0.1, 0.3, 10.0]):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                        * gscale).astype(np.float32), params)
        rp, ro, rn = ref_opt.adamw_update(
            jax.tree.map(jnp.asarray, grads), ro, rp, lr=1e-2)
        tp, to, tn = opt.adamw_update(jax.tree.map(torch.as_tensor, grads),
                                      to, tp, lr=1e-2)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
        assert int(to.count) == int(ro.count) == k + 1
        for name in ("m", "v", "master"):
            _close(jax.tree.map(_np, getattr(to, name)), getattr(ro, name),
                   rtol=1e-5, atol=1e-7)
        _close(jax.tree.map(_np, tp), jax.tree.map(
            lambda x: np.asarray(x, np.float32), rp), rtol=1e-5, atol=1e-7)
    assert tp["b"]["d"].dtype == torch.bfloat16
    assert float(tn) > 1.0    # the last step was clipped


def test_compress_tree_matches_reference():
    """Int8 quantization with error feedback, two rounds."""
    rng = np.random.default_rng(4)
    grads = {"w": rng.standard_normal((6, 5)).astype(np.float32),
             "b": [rng.standard_normal((7,)).astype(np.float32)]}
    r_err = t_err = None
    for _ in range(2):
        rq, rs, r_err = ref_compress.compress_tree(
            jax.tree.map(jnp.asarray, grads), r_err)
        tq, ts, t_err = compress.compress_tree(
            jax.tree.map(torch.as_tensor, grads), t_err)
        for g, w in zip(opt.tree_leaves(tq), jax.tree.leaves(rq)):
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        _close(jax.tree.map(_np, ts), rs, rtol=1e-7)
        _close(jax.tree.map(_np, t_err), r_err, rtol=1e-6, atol=1e-7)
    q, s = compress.quantize(torch.zeros((3,)))
    assert q.abs().max() == 0 and float(s) > 0


# -------------------------------------------------- expert product grads --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [5, 128, 160])
def test_grouped_expert_matmul_grads_match_reference(c, dtype):
    """Forward and both gradients of (e, c, d) @ (e, d, f) against
    ``jax.grad`` of the reference's ``einsum("ecd,edf->ecf")``, at a
    capacity below, at and above ``tile_m`` (5 -> one 8-row tile; 128;
    160 -> two 128-row tiles, the full-width training leg's capacity)."""
    e, d, f = 3, 24, 40
    rng = np.random.default_rng(c)
    xe = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    cot = rng.standard_normal((e, c, f)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))

    def ref(x, ww):
        y = jnp.einsum("ecd,edf->ecf", x, ww).astype(jnp.float32)
        return jnp.sum(y * cot)
    want_y = jnp.einsum("ecd,edf->ecf", jnp.asarray(xe, jdt),
                        jnp.asarray(w, jdt))
    want_dx, want_dw = jax.grad(ref, argnums=(0, 1))(jnp.asarray(xe, jdt),
                                                    jnp.asarray(w, jdt))
    tx = torch.as_tensor(xe).to(tdt).requires_grad_()
    tw = torch.as_tensor(w).to(tdt).requires_grad_()
    before = group_matmul.launches
    y = grouped_expert_matmul(tx, tw)
    (y * torch.as_tensor(cot)).sum().backward()
    assert group_matmul.launches == before     # CPU: the plain version
    assert y.dtype == torch.float32 and y.shape == (e, c, f)
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    for got, want in ((y, want_y), (tx.grad, want_dx), (tw.grad, want_dw)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)


def test_grouped_expert_matmul_grad_needs_only_what_is_asked():
    """A weight that needs no gradient gets none (and no ``bmm``); the
    input's still flows."""
    xe = torch.randn((2, 9, 4), requires_grad=True)
    w = torch.randn((2, 4, 3))
    grouped_expert_matmul(xe, w).sum().backward()
    assert w.grad is None
    torch.testing.assert_close(xe.grad, torch.ones((2, 9, 3)) @
                               w.transpose(1, 2))


# ------------------------------------------------------------ train step --
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", [STABLELM, PHI])
def test_train_step_matches_reference(arch, steps):
    """One and three steps: metrics, parameters and the AdamW state."""
    _check_against_reference(_run_both(arch, steps))


@pytest.mark.parametrize("arch", [STABLELM, PHI])
def test_microbatched_step_matches_reference(arch):
    """microbatch=2: the gradients of the two halves summed in f32."""
    _check_against_reference(_run_both(arch, 2, microbatch=2))


def test_microbatch_2_equals_1_on_a_dense_model():
    """On a dense model the mean of the halves' losses and gradients is
    the whole batch's (the MoE's capacity depends on the tokens a call
    routes, so there it differs)."""
    cfg, _ = _cfgs(STABLELM)
    tree = golden.serve_params_numpy(cfg, 3)
    batch = {k: torch.as_tensor(v) for k, v in
             next(SyntheticTokenStream(cfg.vocab, 4, 16, seed=1)).items()}
    outs = []
    for mb in (None, 2):
        p = params_from_numpy(tree, cfg, "cpu")
        o = opt.adamw_init(p.tree())
        p, o, m = make_train_step(cfg, microbatch=mb)(p, o, batch)
        outs.append((params_to_numpy(p), m))
    (p1, m1), (p2, m2) = outs
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]),
                                   rtol=METRIC_RTOL)
    _close(p2, p1, rtol=1e-5, atol=PARAM_ATOL)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        make_train_step(cfg, microbatch=3)(
            params_from_numpy(tree, cfg, "cpu"), o, batch)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_bit(remat):
    """Two steps with remat equal the steps without it bit for bit:
    metrics, parameters and the AdamW state."""
    runs = []
    for policy in ("none", remat):
        cfg = dataclasses.replace(configs.get_arch(PHI).reduced(),
                                  remat=policy)
        p = params_from_numpy(golden.serve_params_numpy(cfg, 0), cfg, "cpu")
        o = opt.adamw_init(p.tree())
        step = make_train_step(cfg)
        pipe = SyntheticTokenStream(cfg.vocab, 4, 16, seed=0)
        ms = []
        for _ in range(2):
            p, o, m = step(p, o, {k: torch.as_tensor(v)
                                  for k, v in next(pipe).items()})
            ms.append(m)
        runs.append((p.tree(), o, ms))
    (p0, o0, m0), (p1, o1, m1) = runs
    for a, b in zip(opt.tree_leaves([p0, o0.m, o0.v, o0.master, m0]),
                    opt.tree_leaves([p1, o1.m, o1.v, o1.master, m1])):
        assert torch.equal(a, b)


def test_gradients_reach_every_parameter():
    """As ``jax.grad`` in the reference: the router, the expert weights
    (through the expert products and the gates), the norms, attention,
    embedding and unembedding all get a nonzero gradient."""
    cfg, _ = _cfgs(PHI)
    p = params_from_numpy(golden.serve_params_numpy(cfg, 0), cfg, "cpu")
    batch = synth_batch(cfg, 2, 16, torch.Generator().manual_seed(0))
    from repro_torch.train.step import loss_fn
    loss, _ = loss_fn(p, cfg, batch)
    loss.backward()
    for name, t in p.named_parameters():
        assert t.grad is not None and t.grad.abs().sum() > 0, name


# ---------------------------------------------------------- train() loop --
def test_train_runs_and_loss_decreases(tmp_path):
    res = train("stablelm-3b", steps=10, batch=4, seq=32, device="cpu",
                ckpt_dir=str(tmp_path), save_every=5, log_every=0)
    assert res.steps_done == 10 and res.restarts == 0
    assert np.isfinite(res.final_loss)
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])
    assert len(res.grad_norms) == len(res.step_s) == 10


def test_train_recovers_from_failure(tmp_path):
    res = train("stablelm-3b", steps=12, batch=4, seq=32, device="cpu",
                ckpt_dir=str(tmp_path), save_every=4, fail_at_step=9,
                log_every=0)
    assert res.steps_done == 12
    assert res.restarts == 1
    assert np.isfinite(res.final_loss)


def test_train_recovery_is_deterministic(tmp_path):
    """Checkpoint/restore reproduces the uninterrupted run: same data
    stream, same params -> the same losses, bit for bit on the CPU."""
    clean = train("stablelm-3b", steps=10, batch=4, seq=32, log_every=0,
                  device="cpu", ckpt_dir=str(tmp_path / "a"), save_every=5)
    failed = train("stablelm-3b", steps=10, batch=4, seq=32, log_every=0,
                   device="cpu", ckpt_dir=str(tmp_path / "b"), save_every=5,
                   fail_at_step=7)
    assert failed.restarts == 1
    np.testing.assert_allclose(clean.final_loss, failed.final_loss,
                               rtol=1e-5)
    assert failed.losses[:7] == clean.losses[:7]
    assert failed.losses[7:] == clean.losses[5:]


def test_train_without_checkpoint_restarts_from_scratch():
    res = train("stablelm-3b", steps=6, batch=2, seq=32, ckpt_dir=None,
                fail_at_step=3, log_every=0, device="cpu")
    assert res.steps_done == 6 and res.restarts == 1
    assert len(res.losses) == 9 and res.losses[3:6] == res.losses[:3]


def test_train_moe_arch(tmp_path):
    """The MoE path (AM dispatch + load stealing) trains and
    checkpoints."""
    res = train("phi3.5-moe-42b-a6.6b", steps=4, batch=4, seq=16,
                ckpt_dir=str(tmp_path), save_every=2, log_every=0,
                device="cpu")
    assert res.steps_done == 4 and np.isfinite(res.final_loss)
    assert all(a > 0 for a in res.aux_losses)


def test_train_with_failure_matches_reference_train(tmp_path, monkeypatch):
    """The reference's ``train()`` and the port's, from the same f32
    parameters, through a failure and a restore: the same losses."""
    cfg, _ = _cfgs(PHI)
    tree = golden.serve_params_numpy(cfg, 5)
    monkeypatch.setattr(ref_train.lm, "init_params",
                        lambda c, k: jax.tree.map(jnp.asarray, tree))
    kw = dict(steps=5, batch=4, seq=16, save_every=2, fail_at_step=3,
              log_every=0)
    want = ref_train.train("phi3.5-moe-42b-a6.6b",
                           ckpt_dir=str(tmp_path / "ref"), **kw)
    params = params_from_numpy(tree, cfg, "cpu")
    got = train("phi3.5-moe-42b-a6.6b", ckpt_dir=str(tmp_path / "port"),
                device="cpu", params=params, **kw)
    assert (got.steps_done, got.restarts) == (want.steps_done,
                                               want.restarts) == (5, 1)
    np.testing.assert_allclose(got.losses, want.losses, rtol=METRIC_RTOL)
    # the caller's parameters are left as they were
    np.testing.assert_array_equal(
        params_to_numpy(params)["embed"]["e"], tree["embed"]["e"])


def test_restore_gives_trainable_parameters(tmp_path):
    """A checkpoint of (params, AdamW state) restores onto the device as
    trainable parameters and an ``AdamWState`` with its count."""
    train("stablelm-3b", steps=2, batch=2, seq=16, device="cpu",
          ckpt_dir=str(tmp_path), save_every=2, log_every=0)
    cfg, _ = _cfgs(STABLELM)
    like = lm.init_params(cfg, torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path))
    (tree, state), step, extra = mgr.restore(
        (like.tree(), opt.adamw_init(like.tree())), device="cpu")
    params = lm.LM(tree)
    assert step == 2 and extra["data"]["step"] == 2
    assert isinstance(state, opt.AdamWState) and int(state.count) == 2
    assert all(p.requires_grad and p.device.type == "cpu"
               for p in params.parameters())
    assert params["embed"]["e"].dtype == torch.bfloat16


def test_tree_and_state_round_trip_through_numpy():
    cfg, _ = _cfgs(PHI)
    tree = golden.serve_params_numpy(cfg, 1)
    back = params_to_numpy(params_from_numpy(tree, cfg, "cpu"))
    _close(back, tree, rtol=0, atol=0)
    state = dict(m=tree, v=tree, master=tree, count=3)
    back = adamw_to_numpy(adamw_from_numpy(state, cfg, "cpu"))
    assert back["count"] == 3
    _close(back["master"], tree, rtol=0, atol=0)


# ------------------------------------------------------ the 100M example --
def _ref_example():
    spec = importlib.util.spec_from_file_location(
        "ref_train_100m", os.path.join(ROOT, "examples", "train_100m.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cfg_100m_equals_reference():
    want = _ref_example().CFG_100M
    got = train_100m.CFG_100M
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_train_100m_main_runs_and_resumes(tmp_path, monkeypatch, capsys):
    """The example's CLI on the CPU at a tiny width (the real width is
    the card's): it trains, checkpoints, and a rerun resumes."""
    monkeypatch.setattr(train_100m, "CFG_100M", dataclasses.replace(
        train_100m.CFG_100M, n_layers=1, d_model=64, n_heads=2, n_kv=1,
        d_ff=128, vocab=256, head_dim=32))
    argv = ["train_100m", "--steps", "4", "--batch", "2", "--seq", "16",
            "--save-every", "2", "--ckpt-dir", str(tmp_path), "--device",
            "cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    train_100m.main()
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "tok/s" in out
    argv[argv.index("--steps") + 1] = "6"
    train_100m.main()
    out = capsys.readouterr().out
    assert "restored step 4" in out and "done: 2 steps" in out


# ----------------------------------------------------------------- golden --
def reference_train_record() -> dict:
    """The golden record of the reduced training run: the reference's
    ``make_train_step`` from :data:`golden.TRAIN_SPEC`."""
    spec = golden.TRAIN_SPEC
    arch = configs.ALIASES[spec["arch"]]
    cfg, rcfg = _cfgs(arch)
    rp = jax.tree.map(jnp.asarray,
                      golden.serve_params_numpy(cfg, spec["param_seed"]))
    ro = ref_opt.adamw_init(rp)
    step = jax.jit(ref_make_train_step(rcfg, lr=spec["lr"]))
    pipe = SyntheticTokenStream(cfg.vocab, spec["batch"], spec["seq"],
                                seed=spec["data_seed"])
    rec = dict(spec=spec, loss=[], aux_loss=[], grad_norm=[])
    for _ in range(spec["steps"]):
        rp, ro, m = step(rp, ro, {k: jnp.asarray(v)
                                  for k, v in next(pipe).items()})
        for k in ("loss", "aux_loss", "grad_norm"):
            rec[k].append(float(m[k]))
    return rec


def port_train_reduced(device="cpu"):
    """The port's ``train()`` on :data:`golden.TRAIN_SPEC`."""
    spec = golden.TRAIN_SPEC
    cfg = configs.get_arch(spec["arch"]).reduced()
    params = params_from_numpy(
        golden.serve_params_numpy(cfg, spec["param_seed"]), cfg, device)
    return train(spec["arch"], steps=spec["steps"], batch=spec["batch"],
                 seq=spec["seq"], lr=spec["lr"], device=device,
                 params=params, log_every=0)


def test_train_golden_matches_fresh_reference_run():
    want = golden.load_train_golden()
    got = reference_train_record()
    assert want["spec"] == got["spec"] == golden.TRAIN_SPEC
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_port_train_meets_the_golden_record():
    res = port_train_reduced()
    golden.check_train(res.losses, res.aux_losses, res.grad_norms,
                       golden.load_train_golden())
    # and closer than the card's tolerance on the CPU
    golden.check_train(res.losses, res.aux_losses, res.grad_norms,
                       golden.load_train_golden(), rtol=METRIC_RTOL)


def test_train_golden_check_catches_a_wrong_loss():
    want = golden.load_train_golden()
    bad = list(want["loss"])
    bad[3] *= 1 + 3 * golden.TRAIN_RTOL
    with pytest.raises(AssertionError, match="loss at step 3"):
        golden.check_train(bad, want["aux_loss"], want["grad_norm"], want)
    with pytest.raises(AssertionError, match="steps of grad_norm"):
        golden.check_train(want["loss"], want["aux_loss"],
                           want["grad_norm"][:-1], want)


if __name__ == "__main__":
    with open(golden.TRAIN_GOLDEN_PATH, "w") as f:
        json.dump(reference_train_record(), f, indent=1)
        f.write("\n")
    print("wrote", golden.TRAIN_GOLDEN_PATH)
