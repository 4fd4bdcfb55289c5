"""Training the audio and vision families on the port against the
reference on the CPU: ``synth_batch``'s frontend batches, ``loss_fn``'s
VLM text region and the encoder's masked, unshifted loss, one AdamW step
of the reduced HuBERT and LLaVA (whole and in microbatches) equal to the
reference's, and the committed record of the five reduced families'
training runs (``golden/train_families_reduced.json``), which the card is
held to, equal to what the reference gives today.

Every comparison feeds both packages the same f32 parameters
(``golden.serve_params_numpy``) and the same numpy batches, in f32 (the
reference's ``synth_batch`` makes bf16 frames and patches; f32 keeps the
comparison at ``test_torch_train.py``'s tolerances).

Regenerate ``src/repro_torch/golden/train_families_reduced.json`` from the
reference with::

    PYTHONPATH=src:. python tests/test_torch_train_families.py
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.step import loss_fn as ref_loss_fn  # noqa: E402
from repro.train.step import make_train_step as ref_make_train_step  # noqa: E402
from repro.train.step import synth_batch as ref_synth_batch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.step import (loss_fn, make_train_step,  # noqa: E402
                                    synth_batch)
from test_torch_train import METRIC_RTOL, _check_against_reference  # noqa: E402

SPEC = golden.TRAIN_FAMILIES_SPEC
FRONTENDS = ["hubert-xlarge", "llava-next-mistral-7b"]


def _cfgs(arch):
    name = configs.ALIASES[arch]
    return configs.get_arch(name).reduced(), \
        ref_configs.get_arch(name).reduced()


def _batch(cfg, batch, seed):
    """A numpy batch of ``batch`` rows shaped as the record's."""
    return golden.train_family_batch(cfg, batch=batch, seed=seed)


@functools.lru_cache(maxsize=None)
def _ref_step(arch, microbatch, lr, aux_weight=0.01):
    _, rcfg = _cfgs(arch)
    return jax.jit(ref_make_train_step(rcfg, lr=lr, microbatch=microbatch,
                                       aux_weight=aux_weight))


def _run_both(arch, batches, *, microbatch=None, lr=3e-4):
    """One step a batch of the reference and of the port from the same f32
    parameters, in ``_check_against_reference``'s layout."""
    cfg, _ = _cfgs(arch)
    tree = golden.serve_params_numpy(cfg, 0)
    rp = jax.tree.map(jnp.asarray, tree)
    ro = ref_opt.adamw_init(rp)
    tp = params_from_numpy(tree, cfg, "cpu")
    to = opt.adamw_init(tp.tree())
    step = make_train_step(cfg, lr=lr, microbatch=microbatch)
    rms, tms = [], []
    for b in batches:
        rp, ro, rm = _ref_step(arch, microbatch, lr)(
            rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = step(tp, to, {k: torch.as_tensor(v)
                                   for k, v in b.items()})
        rms.append({k: float(v) for k, v in rm.items()})
        tms.append({k: float(v) for k, v in tm.items()})
    return rp, ro, rms, tp, to, tms


def reference_train_families_record() -> dict:
    """The reference's run of every arch of :data:`golden.TRAIN_FAMILIES_SPEC`
    on the CPU: the record ``train_families_reduced.json`` holds."""
    out = {}
    for arch in SPEC["archs"]:
        cfg, _ = _cfgs(arch)
        rp = jax.tree.map(jnp.asarray,
                          golden.serve_params_numpy(cfg, SPEC["param_seed"]))
        ro = ref_opt.adamw_init(rp)
        step = _ref_step(arch, None, SPEC["lr"], SPEC["aux_weight"])
        batch = {k: jnp.asarray(v)
                 for k, v in golden.train_family_batch(cfg).items()}
        rec = {"loss": [], "aux_loss": [], "grad_norm": []}
        for _ in range(SPEC["steps"]):
            rp, ro, m = step(rp, ro, batch)
            for k in rec:
                rec[k].append(float(m[k]))
        out[arch] = rec
    return {"spec": SPEC, "archs": out}


@pytest.fixture(scope="module")
def fresh_record():
    return reference_train_families_record()


# ------------------------------------------------------------ synth_batch --
@pytest.mark.parametrize("arch", FRONTENDS + ["zamba2-1.2b"])
def test_synth_batch_has_the_reference_shapes_and_dtypes(arch):
    """The reference's batch: bf16 frames and a mask of ones for the
    encoder, the text region after bf16 patches for the VLM (its tokens
    are its labels, one key drawing both in the reference), tokens for a
    text model; all on the generator's device."""
    cfg, rcfg = _cfgs(arch)
    got = synth_batch(cfg, 2, 24, torch.Generator().manual_seed(0))
    want = ref_synth_batch(rcfg, 2, 24)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        assert g.device.type == "cpu"
        if k in ("tokens", "labels"):
            assert 0 <= int(g.min()) and int(g.max()) < cfg.vocab
    if "tokens" in got:
        assert torch.equal(got["tokens"], got["labels"])
    if "mask" in got:
        assert bool((got["mask"] == 1).all())


# ------------------------------------------------------------------ loss --
@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_matches_reference_with_a_partial_mask(arch):
    """The VLM's loss over its text region only, and the encoder's masked,
    unshifted loss (a mask with zeros, so the mask is what is tested), equal
    the reference's."""
    cfg, rcfg = _cfgs(arch)
    tree = golden.serve_params_numpy(cfg, 3)
    b = _batch(cfg, 2, 5)
    if "mask" in b:
        b["mask"][:, ::3] = 0
    want, want_aux = ref_loss_fn(jax.tree.map(jnp.asarray, tree), rcfg,
                                 {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got, aux = loss_fn(params_from_numpy(tree, cfg, "cpu"), cfg,
                           {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=METRIC_RTOL)
    assert float(aux) == float(want_aux) == 0.0


# ------------------------------------------------------------ train step --
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_train_step_matches_reference(arch):
    """One AdamW step of the reduced encoder and VLM: metrics, parameters
    and optimizer state at ``test_torch_train.py``'s tolerances."""
    cfg, _ = _cfgs(arch)
    _check_against_reference(_run_both(arch, [_batch(cfg, 4, 1)]))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_microbatched_steps_match_reference(arch):
    """microbatch=2 over frames + mask (or patches + tokens) batches: every
    leaf of the batch is split, and two steps equal the reference's."""
    cfg, _ = _cfgs(arch)
    _check_against_reference(_run_both(
        arch, [_batch(cfg, 4, 1), _batch(cfg, 4, 2)], microbatch=2))


def test_encoder_microbatch_2_equals_1():
    """HuBERT has no experts and a mask of ones: the mean of the halves'
    losses and gradients is the whole batch's."""
    cfg, _ = _cfgs("hubert-xlarge")
    tree = golden.serve_params_numpy(cfg, 1)
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 4, 4).items()}
    out = []
    for mb in (None, 2):
        p = params_from_numpy(tree, cfg, "cpu")
        st = opt.adamw_init(p.tree())
        _, st, m = make_train_step(cfg, microbatch=mb)(p, st, b)
        out.append((m, st))
    (m1, s1), (m2, s2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    for a, b_ in zip(opt.tree_leaves(s1.m), opt.tree_leaves(s2.m)):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-8)


# ---------------------------------------------------------- golden record --
def test_train_families_golden_matches_fresh_reference_run(fresh_record):
    """The committed record is what the reference gives today."""
    want = golden.load_train_families_golden()
    assert want["spec"] == json.loads(json.dumps(fresh_record["spec"]))
    assert sorted(want["archs"]) == sorted(SPEC["archs"])
    for arch in SPEC["archs"]:
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(fresh_record["archs"][arch][k],
                                       want["archs"][arch][k], rtol=1e-6,
                                       err_msg=f"{arch} {k}")
        # the same batch at every step: the loss falls
        assert want["archs"][arch]["loss"][-1] < want["archs"][arch]["loss"][0]


@pytest.mark.parametrize("arch", SPEC["archs"])
def test_port_meets_the_train_families_record(arch):
    """The port's run of each family meets the record at the card's limit,
    ``golden.TRAIN_RTOL``."""
    got = golden.train_family_run(arch, "cpu")
    golden.check_train(got["loss"], got["aux_loss"], got["grad_norm"],
                       golden.load_train_families_golden()["archs"][arch])


def test_train_families_check_catches_a_nonzero_aux_loss():
    """A family without experts records an aux loss of exactly 0: any other
    value fails, and its relative error reads inf."""
    want = golden.load_train_families_golden()["archs"]["zamba2-1.2b"]
    aux = list(want["aux_loss"])
    aux[2] = 1e-9
    with pytest.raises(AssertionError, match="aux_loss at step 2"):
        golden.check_train(want["loss"], aux, want["grad_norm"], want)
    assert golden.train_rel_errs(want["loss"], aux, want["grad_norm"],
                                 want)["aux_loss"] == float("inf")


if __name__ == "__main__":
    with open(golden.TRAIN_FAMILIES_GOLDEN_PATH, "w") as f:
        json.dump(reference_train_families_record(), f, indent=1)
        f.write("\n")
    print("wrote", golden.TRAIN_FAMILIES_GOLDEN_PATH)
