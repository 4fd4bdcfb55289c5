"""The port's serving launcher against the reference's on the CPU: the same
f32 parameters (the reference's ``lm.init_params`` is monkeypatched to
return them) and the same requests give the same greedy tokens, at the
reduced Phi-3.5-MoE and the reduced ``stablelm-3b`` (the reference's own
serving test arch).  Both use f32 parameters: in bf16 the two frameworks
round the products at different places, and a near-tie between two
logits could flip a token.

The card run is held to ``src/repro_torch/golden/serve_reduced.json``;
regenerate it from the reference with::

    PYTHONPATH=src:. python tests/test_torch_serve.py
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve as ref_serve  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def _traffic(spec):
    return {k: spec[k] for k in ("max_new_tokens", "batch_slots",
                                 "cache_len")}


def token_margins(requests, steps, *, max_new_tokens, batch_slots,
                  cache_len):
    """Each served token and its top-2 logit margin (the gap by which the
    greedy token won), per request.  ``steps`` holds (greedy tokens (B,),
    margins (B,)) of every forward ``serve_batch`` ran, prefill first;
    ``serve_batch``'s slot schedule (no eos) says which forward produced
    each token: the last generating step before the slot loop's pass,
    with ``len(prompt) - 1`` replay steps after each refill."""
    pending = list(range(len(requests)))
    slot_req = [pending.pop(0) if pending else -1
                for _ in range(batch_slots)]
    slot_left = [max_new_tokens if r >= 0 else 0 for r in slot_req]
    out = [[] for _ in requests]
    cur, nxt = 0, 1                 # the step read now, the next step run
    while any(r >= 0 for r in slot_req):
        toks, margins = steps[cur]
        for s in range(batch_slots):
            rid = slot_req[s]
            if rid < 0 or slot_left[s] <= 0:
                continue
            out[rid].append((int(toks[s]), float(margins[s])))
            slot_left[s] -= 1
            if slot_left[s] == 0:
                if pending:
                    slot_req[s] = pending.pop(0)
                    slot_left[s] = max_new_tokens
                    nxt += min(len(requests[slot_req[s]]),
                               cache_len // 2) - 1
                else:
                    slot_req[s] = -1
        cur, nxt = nxt, nxt + 1
    assert cur == len(steps), (cur, len(steps))
    return out


def serve_both(arch, requests, seed, **traffic):
    """(reference result, port result, each port token's margin per
    request) on the same f32 parameters.  The port's forwards are logged
    by wrapping ``lm.forward``; the margins are checked to belong to the
    served tokens."""
    cfg = configs.get_arch(configs.ALIASES.get(arch, arch)).reduced()
    tree = golden.serve_params_numpy(cfg, seed)
    orig = ref_serve.lm.init_params
    ref_serve.lm.init_params = lambda c, k: jax.tree.map(jnp.asarray, tree)
    try:
        want = ref_serve.serve_batch(arch, requests, **traffic)
    finally:
        ref_serve.lm.init_params = orig
    steps, forward = [], lm.forward

    def logged(*args, **kw):
        logits, caches, aux = forward(*args, **kw)
        last = logits[:, -1, :].float()
        top = torch.topk(last, 2, dim=-1).values
        steps.append((torch.argmax(last, dim=-1).numpy(),
                      (top[:, 0] - top[:, 1]).numpy()))
        return logits, caches, aux

    lm.forward = logged
    try:
        got = serve.serve_batch(arch, requests, device="cpu",
                                params=params_from_numpy(tree, cfg, "cpu"),
                                **traffic)
    finally:
        lm.forward = forward
    per_req = token_margins(requests, steps, **traffic)
    assert [[t for t, _ in r] for r in per_req] == \
        [o.tolist() for o in got.outputs]
    return want, got, [np.array([m for _, m in r]) for r in per_req]


def reference_serve_golden() -> dict:
    """The golden record of the reduced serving run: the reference's
    tokens, and each token's top-2 logit margin from the port's f32 CPU
    run (whose tokens must equal the reference's)."""
    spec = golden.SERVE_SPEC
    reqs = golden.serve_requests()
    want, got, margins = serve_both(spec["arch"], reqs, spec["param_seed"],
                                    **_traffic(spec))
    for w, g in zip(want.outputs, got.outputs):
        np.testing.assert_array_equal(g, w)
    return dict(spec=spec, requests=[r.tolist() for r in reqs],
                tokens=[o.tolist() for o in want.outputs],
                margins=[[round(float(m), 6) for m in ms]
                         for ms in margins])


@pytest.fixture(scope="module")
def phi_runs():
    spec = golden.SERVE_SPEC
    return serve_both(spec["arch"], golden.serve_requests(),
                      spec["param_seed"], **_traffic(spec))


def test_serve_reduced_phi_moe_matches_reference(phi_runs):
    """examples/serve_moe.py's traffic (6 requests, 3 slots, so three
    refills by decode replay) on the reduced Phi-3.5-MoE."""
    want, got, margins = phi_runs
    assert got.tokens_generated == want.tokens_generated == 48
    for w, g in zip(want.outputs, got.outputs):
        np.testing.assert_array_equal(g, w)
    assert all(len(m) == 8 and (m >= 0).all() for m in margins)


def test_serve_reduced_stablelm_matches_reference():
    """The reference's serving test (5 requests of 8 tokens, 2 slots, 6
    new tokens) on the reduced dense ``stablelm-3b``."""
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, 500, size=(8,)) for _ in range(5)]
    want, got, _ = serve_both("stablelm-3b", reqs, 1, max_new_tokens=6,
                           batch_slots=2, cache_len=128)
    assert got.tokens_generated == want.tokens_generated == 30
    for w, g in zip(want.outputs, got.outputs):
        np.testing.assert_array_equal(g, w)


def test_serve_golden_file_matches_reference(phi_runs):
    """The committed golden record is what the reference gives today, and
    the port's CPU run meets it at every token."""
    want = golden.load_serve_golden()
    ref, port, margins = phi_runs
    assert want["spec"] == golden.SERVE_SPEC
    assert want["requests"] == [r.tolist() for r in golden.serve_requests()]
    assert want["tokens"] == [o.tolist() for o in ref.outputs]
    np.testing.assert_allclose(np.concatenate(margins),
                               np.concatenate(want["margins"]), atol=1e-4)
    assert golden.check_serve_tokens(port.outputs, want) == sum(
        next((j for j, m in enumerate(ms) if m < golden.SERVE_MARGIN),
             len(ms)) for ms in want["margins"])


def test_serve_golden_check_catches_a_wrong_token():
    want = golden.load_serve_golden()
    bad = [list(t) for t in want["tokens"]]
    bad[0][0] += 1
    with pytest.raises(AssertionError, match="request 0 token 0"):
        golden.check_serve_tokens(bad, want)
    with pytest.raises(AssertionError, match="requests served"):
        golden.check_serve_tokens(bad[:-1], want)


def test_serve_rejects_encoder_only():
    with pytest.raises(AssertionError, match="encoder-only"):
        serve.serve_batch("hubert-xlarge", [np.array([1, 2, 3])],
                          device="cpu")


if __name__ == "__main__":
    with open(golden.SERVE_GOLDEN_PATH, "w") as f:
        json.dump(reference_serve_golden(), f, indent=1)
        f.write("\n")
    print("wrote", golden.SERVE_GOLDEN_PATH)
