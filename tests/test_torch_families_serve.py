"""The other model families through the port's entry points against the
reference's on the CPU: ``serve_batch`` of the four reduced decoder
families (Zamba2, xLSTM, DeepSeek-V2-Lite, LLaVA as text) gives the
reference's greedy tokens on the same f32 parameters (the reference's
``lm.init_params`` is monkeypatched to return them), ``encode_step`` of
the reduced HuBERT gives its logits, one train step of the text
families gives the reference's, and the committed record of these runs,
which the card is held to, is what the reference gives today.

Regenerate ``src/repro_torch/golden/families_reduced.json`` from the
reference with::

    PYTHONPATH=src:. python tests/test_torch_families_serve.py
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve import steps as ref_steps  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.steps import encode_step  # noqa: E402
from test_torch_serve import _traffic, serve_both  # noqa: E402
from test_torch_train import _check_against_reference, _run_both  # noqa: E402

SPEC = golden.FAMILIES_SPEC


def _cfgs(arch):
    name = configs.ALIASES.get(arch, arch)
    return configs.get_arch(name).reduced(), \
        ref_configs.get_arch(name).reduced()


def _serve(arch):
    """(reference result, port result, margins) of the family's serve."""
    return serve_both(arch, golden.serve_requests(), SPEC["param_seed"],
                      **_traffic(golden.SERVE_SPEC))


def _logits(kind):
    """(reference logits, port logits) of the encode or vision record:
    HuBERT's ``encode_step`` of seeded frames, or one ``lm.forward`` of
    LLaVA over seeded patches and tokens."""
    cfg, rcfg = _cfgs(SPEC[kind]["arch"])
    tree = golden.serve_params_numpy(cfg, SPEC["param_seed"])
    rp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, cfg,
                                                                "cpu")
    inp = golden.family_inputs(cfg, kind)
    if kind == "encode":
        want = ref_steps.encode_step(rcfg)(rp, jnp.asarray(inp["frames"]))
        got = encode_step(cfg)(tp, torch.as_tensor(inp["frames"]))
    else:
        want, _, _ = ref_lm.forward(rp, rcfg, {k: jnp.asarray(v)
                                               for k, v in inp.items()})
        got, _, _ = lm.forward(tp, cfg, {k: torch.as_tensor(v)
                                         for k, v in inp.items()})
    return np.asarray(want, np.float32), got.detach().numpy()


class _Runs:
    """Each run (a served arch, ``"encode"`` or ``"vision"``) made once,
    when first asked for."""

    def __init__(self):
        self.cache = {}

    def __call__(self, key):
        if key not in self.cache:
            self.cache[key] = _logits(key) if key in ("encode", "vision") \
                else _serve(key)
        return self.cache[key]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("arch", SPEC["serve"])
def test_serve_matches_reference(runs, arch):
    """``examples/serve_moe.py``'s traffic (6 requests, 3 slots: three
    refills by decode replay, 8 new tokens each) on each reduced decoder
    family: the port's greedy tokens are the reference's."""
    want, got, margins = runs(arch)
    assert got.tokens_generated == want.tokens_generated == 48
    for w, g in zip(want.outputs, got.outputs):
        np.testing.assert_array_equal(g, w)
    assert all(len(m) == 8 and (m >= 0).all() for m in margins)


@pytest.mark.parametrize("kind", ["encode", "vision"])
def test_encode_and_vision_logits_match_reference(runs, kind):
    """HuBERT's ``encode_step`` (2 x 16 frames) and LLaVA's forward over 8
    patches and 8 tokens, rtol = atol = 1e-4."""
    want, got = runs(kind)
    np.testing.assert_allclose(got, want, rtol=golden.FAMILIES_TOL,
                               atol=golden.FAMILIES_TOL)


def _as_record(logits) -> dict:
    return dict(shape=list(logits.shape),
                logits=[float(f"{v:.7g}") for v in logits.ravel()])


def reference_families_golden(runs) -> dict:
    """The golden record: each decoder family's tokens from the reference
    with each token's top-2 margin from the port's f32 CPU run (whose
    tokens must equal the reference's), and the reference's encode and
    vision logits (7 significant digits)."""
    serve = {}
    for arch in SPEC["serve"]:
        want, got, margins = runs(arch)
        for w, g in zip(want.outputs, got.outputs):
            np.testing.assert_array_equal(g, w)
        serve[arch] = dict(tokens=[o.tolist() for o in want.outputs],
                           margins=[[round(float(m), 6) for m in ms]
                                    for ms in margins])
    return dict(spec=SPEC, traffic=_traffic(golden.SERVE_SPEC),
                requests=[r.tolist() for r in golden.serve_requests()],
                serve=serve, encode=_as_record(runs("encode")[0]),
                vision=_as_record(runs("vision")[0]))


def test_families_golden_file_matches_reference(runs):
    """The committed record is what the reference gives today (tokens
    equal, margins within 1e-4, logits within 1e-6 of a fresh run: the
    record keeps 7 digits), and the port's CPU runs meet it as the card
    must."""
    want = golden.load_families_golden()
    fresh = reference_families_golden(runs)
    for k in ("spec", "traffic", "requests"):
        assert want[k] == json.loads(json.dumps(fresh[k])), k
    for arch in SPEC["serve"]:
        assert want["serve"][arch]["tokens"] == fresh["serve"][arch]["tokens"]
        np.testing.assert_allclose(
            np.concatenate(want["serve"][arch]["margins"]),
            np.concatenate(fresh["serve"][arch]["margins"]), atol=1e-4)
        assert golden.check_serve_tokens(runs(arch)[1].outputs,
                                         want["serve"][arch]) > 0
    for kind in ("encode", "vision"):
        assert want[kind]["shape"] == fresh[kind]["shape"]
        np.testing.assert_allclose(want[kind]["logits"],
                                   fresh[kind]["logits"], rtol=1e-6,
                                   atol=1e-6)
        assert golden.check_logits(runs(kind)[1], want[kind]) < \
            golden.FAMILIES_TOL


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_350m",
                                  "deepseek_v2_lite_16b"])
def test_train_step_matches_reference(arch):
    """The text families train: one AdamW step of the reduced Zamba2, xLSTM
    and DeepSeek-V2-Lite (4 x 32 tokens) gives the reference's metrics,
    parameters and optimizer state, at ``test_torch_train.py``'s
    tolerances."""
    _check_against_reference(_run_both(arch, 1))


def test_check_logits_catches_a_wrong_logit_and_shape():
    want = golden.load_families_golden()["encode"]
    got = np.asarray(want["logits"], np.float32).reshape(want["shape"])
    assert golden.check_logits(got, want) == 0.0
    bad = got.copy()
    bad[1, 3, 5] += 1e-3
    with pytest.raises(AssertionError, match="differ"):
        golden.check_logits(bad, want)
    with pytest.raises(AssertionError, match="shape"):
        golden.check_logits(got[:1], want)


if __name__ == "__main__":
    with open(golden.FAMILIES_GOLDEN_PATH, "w") as f:
        json.dump(reference_families_golden(_Runs()), f)
        f.write("\n")
    print("wrote", golden.FAMILIES_GOLDEN_PATH)
