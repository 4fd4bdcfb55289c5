"""The port's model zoo slice against the reference on the CPU: the config
copies, the transformer layers, the MoE layer (with equal routing) and the
LM forward at the reduced Phi-3.5-MoE, all from seeded numpy inputs and
f32 parameters (``params_from_numpy``), atol = rtol = 1e-4: only the
summation order of the products differs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def _phi():
    return configs.get_arch("phi35_moe_42b").reduced()


def _ref_phi():
    return ref_configs.get_arch("phi35_moe_42b").reduced()


def _both_params(cfg, seed=0):
    tree = golden.serve_params_numpy(cfg, seed)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, cfg,
                                                              "cpu")


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    """Every config and its ``reduced()`` equal the reference's, field for
    field, with the same parameter counts."""
    got, want = configs.get_arch(arch), ref_configs.get_arch(arch)
    for g, w in ((got, want), (got.reduced(), want.reduced())):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert g.param_count() == w.param_count()
        assert g.active_param_count() == w.active_param_count()
        assert g.hd == w.hd


def test_config_tables_equal_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.ALIASES == ref_configs.ALIASES
    assert configs.SHAPES == ref_configs.SHAPES
    for alias, name in configs.ALIASES.items():
        assert configs.get_arch(alias) == configs.get_arch(name)
    assert [c[:3] for c in configs.cells()] == \
        [c[:3] for c in ref_configs.cells()]


# -------------------------------------------------------------- layers --
def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    _close(L.rmsnorm({"g": torch.as_tensor(g)}, torch.as_tensor(x)),
           RL.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x)))
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
               RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_norm_rope_and_cache_inits_match_reference():
    """``rmsnorm_init``, ``rope_freqs`` and ``make_cache`` (which
    ``lm.make_caches`` lays out per layer) give the reference's values,
    shapes and dtypes on the device they are asked for."""
    _close(L.rmsnorm_init(16, "cpu")["g"], RL.rmsnorm_init(16)["g"])
    for theta in (1e4, 1e6):
        _close(L.rope_freqs(16, theta, "cpu"), RL.rope_freqs(16, theta))
    for dt, rdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got, want = L.make_cache(2, 3, 8, 4, dt, "cpu"), \
            RL.make_cache(2, 3, 8, 4, rdt)
        for k in ("k", "v"):
            assert got[k].shape == want[k].shape and got[k].dtype == dt
            assert got[k].device.type == "cpu" and not got[k].any()
    cfg = _phi()
    caches = lm.make_caches(cfg, 2, 32, dtype=torch.float32, device="cpu")
    want = ref_lm.make_caches(_ref_phi(), 2, 32, dtype=jnp.float32)
    for k in ("k", "v"):
        assert caches["blocks"][k].shape == want["blocks"][k].shape


def _attn_params(rng, d, h, kv, hd):
    return {"wq": rng.standard_normal((d, h * hd)) * d ** -0.5,
            "wk": rng.standard_normal((d, kv * hd)) * d ** -0.5,
            "wv": rng.standard_normal((d, kv * hd)) * d ** -0.5,
            "wo": rng.standard_normal((h * hd, d)) * (h * hd) ** -0.5}


def _as(p, lib):
    conv = (lambda a: torch.as_tensor(np.float32(a))) if lib == "torch" \
        else (lambda a: jnp.asarray(np.float32(a)))
    return {k: conv(v) for k, v in p.items()}


@pytest.mark.parametrize("case", ["no_cache", "no_cache_chunked",
                                  "no_cache_causal_skip", "prefill",
                                  "decode", "clamped_write"])
def test_attention_matches_reference(case):
    """Grouped-query attention without a cache (one and several query
    blocks, and the causal skip that reads only the visible keys), a
    prefill into a cache, a decode step against it, and a write past the
    cache end that XLA's ``dynamic_update_slice`` clamps."""
    rng = np.random.default_rng(len(case))
    d, h, kv, hd, theta = 32, 4, 2, 8, 1e4
    p = _attn_params(rng, d, h, kv, hd)
    kw = dict(n_heads=h, n_kv=kv, hd=hd, theta=theta)
    s = 8 if case in ("no_cache", "prefill", "decode", "clamped_write") \
        else 768
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    if case.startswith("no_cache"):
        skip = case == "no_cache_causal_skip"
        y, _ = L.attention(_as(p, "torch"), torch.as_tensor(x),
                           causal_skip=skip, **kw)
        want, _ = RL.attention(_as(p, "jax"), jnp.asarray(x),
                               causal_skip=skip, **kw)
        _close(y, want)
        return
    size = 16
    cache = {k: rng.standard_normal((2, kv, size, hd)).astype(np.float32)
             for k in ("k", "v")}
    tc = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    steps = {"prefill": [(x, 0)],
             "decode": [(x, 0), (x[:, :1], 8), (x[:, 1:2], 9)],
             "clamped_write": [(x[:, :3], 14)]}[case]
    for xs, ci in steps:
        y, tc = L.attention(_as(p, "torch"), torch.as_tensor(xs), cache=tc,
                            cache_index=ci, **kw)
        want, jc = RL.attention(_as(p, "jax"), jnp.asarray(xs), cache=jc,
                                cache_index=jnp.int32(ci), **kw)
        _close(y, want)
        for k in ("k", "v"):
            _close(tc[k], jc[k])
    if case == "clamped_write":        # landed at 13 = 16 - 3, not at 14
        assert np.array_equal(tc["k"][:, :, :13].numpy(), cache["k"][:, :, :13])


def test_swiglu_matches_reference():
    rng = np.random.default_rng(1)
    p = {"wi": rng.standard_normal((16, 40)) * 0.25,
         "wg": rng.standard_normal((16, 40)) * 0.25,
         "wo": rng.standard_normal((40, 16)) * 40 ** -0.5}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    _close(L.swiglu(_as(p, "torch"), torch.as_tensor(x)),
           RL.swiglu(_as(p, "jax"), jnp.asarray(x)))


# ----------------------------------------------------------------- moe --
class _Record:
    """Wraps a dispatch function and keeps what each call returned."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.calls.append((args[0], out))
        return out


def _routing(monkeypatch, module):
    recs = {}
    for name in ("bucketize", "steal_overflow"):
        recs[name] = _Record(getattr(module, name))
        monkeypatch.setattr(module, name, recs[name])
    return recs


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("load_steal,capacity,t", [
    (True, None, 12), (False, None, 12), (True, 2, 12), (False, 3, 12),
    (True, None, 3)])
def test_moe_apply_matches_reference(monkeypatch, load_steal, capacity, t):
    """Outputs, aux stats and routing (the top-k choice, the destinations
    after stealing, the bucket slots and what was kept) equal the
    reference's, with and without load stealing and at a fixed
    capacity."""
    cfg = dataclasses.replace(_phi().moe, load_steal=load_steal)
    rcfg = dataclasses.replace(_ref_phi().moe, load_steal=load_steal)
    tree = golden.serve_params_numpy(_phi(), 2)["blocks"]["moe"]
    layer = {k: v[0] for k, v in tree.items()}
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t // 3, 128)).astype(np.float32)
    ref_rec = _routing(monkeypatch, ref_moe)
    port_rec = _routing(monkeypatch, moe)
    want, waux = ref_moe.moe_apply(_as(layer, "jax"), jnp.asarray(x), rcfg,
                                   deterministic_capacity=capacity)
    got, gaux = moe.moe_apply(_as(layer, "torch"), torch.as_tensor(x), cfg,
                              deterministic_capacity=capacity)
    _close(got, want)
    for k in ("aux_loss", "expert_util", "dropped_frac"):
        _close(gaux[k], waux[k])
    for name in ("steal_overflow", "bucketize"):
        assert len(port_rec[name].calls) == len(ref_rec[name].calls)
        for (gin, gout), (win, wout) in zip(port_rec[name].calls,
                                            ref_rec[name].calls):
            np.testing.assert_array_equal(_np(gin), _np(win))  # choice/dest
            gout = gout if isinstance(gout, tuple) else (gout,)
            wout = wout if isinstance(wout, tuple) else (wout,)
            for g, w in zip(gout, wout):
                np.testing.assert_array_equal(_np(g), _np(w))
    if capacity == 2:
        assert float(gaux["dropped_frac"]) > 0 or load_steal


def test_moe_top_k_takes_the_lower_index_on_ties():
    """Equal router probabilities choose the lower expert first, as
    ``jax.lax.top_k``."""
    cfg = _phi().moe
    d, e = 8, cfg.n_experts
    p = {"router": torch.zeros((d, e)),
         "wi": torch.ones((e, d, cfg.d_expert)),
         "wg": torch.ones((e, d, cfg.d_expert)),
         "wo": torch.ones((e, cfg.d_expert, d))}
    rec = _Record(moe.bucketize)
    moe.bucketize, keep = rec, moe.bucketize
    try:
        moe.moe_apply(p, torch.ones((1, 2, d)), dataclasses.replace(
            cfg, load_steal=False))
    finally:
        moe.bucketize = keep
    assert rec.calls[0][0].tolist() == [0, 1, 0, 1]


# ------------------------------------------------------------------ lm --
def test_lm_forward_matches_reference():
    """The LM at the reduced Phi-3.5-MoE: a forward without a cache, a
    prefill into f32 caches and two decode steps."""
    cfg, rcfg = _phi(), _ref_phi()
    rp, tp = _both_params(cfg, 1)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    want, _, waux = ref_lm.forward(rp, rcfg, {"tokens": jnp.asarray(toks)})
    got, _, gaux = lm.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    _close(got, want)
    _close(gaux, waux)
    rc = ref_lm.make_caches(rcfg, 2, 32, dtype=jnp.float32)
    tc = lm.make_caches(cfg, 2, 32, dtype=torch.float32, device="cpu")
    steps = [(toks, 0)] + [(rng.integers(0, cfg.vocab, (2, 1)).astype(
        np.int32), ci) for ci in (9, 10)]
    for tk, ci in steps:
        want, rc, _ = ref_lm.forward(rp, rcfg, {"tokens": jnp.asarray(tk)},
                                     caches=rc, cache_index=jnp.int32(ci))
        got, tc, _ = lm.forward(tp, cfg, {"tokens": torch.as_tensor(tk)},
                                caches=tc, cache_index=ci)
        _close(got, want)
        for k in ("k", "v"):
            _close(tc["blocks"][k], rc["blocks"][k])


def test_init_params_shapes_and_dtypes():
    """``init_params`` has the reference's shapes and dtypes (bf16
    weights, f32 norms and router), on the generator's device."""
    cfg = _phi()
    gen = torch.Generator(device="cpu").manual_seed(0)
    got = lm.init_params(cfg, gen)
    want = jax.eval_shape(lambda: ref_lm.init_params(
        _ref_phi(), jax.random.PRNGKey(0)))
    flat = dict(got.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == sum(
        cfg.n_layers if p[0].key == "blocks" else 1 for p, _ in leaves)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            for i in range(cfg.n_layers):
                t = flat[".".join(["blocks", str(i)] + keys[1:])]
                assert tuple(t.shape) == leaf.shape[1:]
                assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name
        else:
            t = flat[".".join(keys)]
            assert tuple(t.shape) == leaf.shape
            assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name
