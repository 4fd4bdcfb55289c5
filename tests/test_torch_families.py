"""The port's other model families against the reference on the CPU: the
GELU MLP, the audio and vision frontends, MLA, the Mamba-2 SSD block and
the xLSTM blocks, then ``lm.forward`` of the five reduced families (no
cache, a prefill into f32 caches and two decode steps, the caches leaf by
leaf), the parameter trees of all ten configs, and the Zamba2 and xLSTM
trees through a checkpoint in the reference's on-disk layout.  Inputs
come from numpy seeds and parameters from ``golden.serve_params_numpy``
(f32), atol = rtol = 1e-4: only the summation order of the products
differs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.checkpoint import store as ref_store  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import multimodal as ref_mm  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm, mamba2, mla, multimodal, xlstm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["xlstm_350m", "zamba2_1p2b", "deepseek_v2_lite_16b",
            "hubert_xlarge", "llava_next_mistral_7b"]


def _close(got, want, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def _both(tree):
    """A numpy tree as (jax arrays, torch tensors)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _cfgs(arch, **over):
    return (dataclasses.replace(configs.get_arch(arch).reduced(), **over),
            dataclasses.replace(ref_configs.get_arch(arch).reduced(), **over))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -------------------------------------------------- GELU MLP, frontends --
def test_gelu_mlp_matches_reference():
    """The tanh GELU (``jax.nn.gelu``'s default), not the exact erf one."""
    cfg, _ = _cfgs("hubert_xlarge")
    rp, tp = _both(_layer0(golden.serve_params_numpy(cfg, 4)["blocks"]
                           ["mlp"]))
    x = _x(1, 2, 5, cfg.d_model) * 3
    want = RL.gelu_mlp(rp, jnp.asarray(x))
    _close(L.gelu_mlp(tp, torch.as_tensor(x)), want)
    erf = torch.nn.functional.gelu(torch.as_tensor(x) @ tp["wi"]) @ tp["wo"]
    assert not np.allclose(erf.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["hubert_xlarge", "llava_next_mistral_7b"])
def test_frontends_match_reference(arch):
    cfg, _ = _cfgs(arch)
    rp, tp = _both(golden.serve_params_numpy(cfg, 5)["frontend"])
    if cfg.frontend == "audio":
        x = _x(2, 2, 7, 512)
        _close(multimodal.audio_frontend(tp, torch.as_tensor(x)),
               ref_mm.audio_frontend(rp, jnp.asarray(x)))
    else:
        x = _x(3, 2, cfg.n_patches, cfg.d_frontend)
        _close(multimodal.vision_connector(tp, torch.as_tensor(x)),
               ref_mm.vision_connector(rp, jnp.asarray(x)))


# ----------------------------------------------------------------- MLA --
@pytest.mark.parametrize("case", ["no_cache", "prefill_decode",
                                  "causal_skip"])
def test_mla_attention_matches_reference(case):
    """MLA without a cache, a prefill into a cache and two decode steps
    against it (the latent cache leaf by leaf), and the block-causal skip
    at s = 512 (two query blocks of 256)."""
    cfg, rcfg = _cfgs("deepseek_v2_lite_16b")
    rp, tp = _both(_layer0(golden.serve_params_numpy(cfg, 6)["blocks"]
                           ["attn"]))
    kw = dict(n_heads=cfg.n_heads, theta=cfg.rope_theta)
    if case != "prefill_decode":
        s = 512 if case == "causal_skip" else 8
        x = _x(7, 2, s, cfg.d_model)
        skip = case == "causal_skip"
        y, _ = mla.mla_attention(tp, torch.as_tensor(x), cfg=cfg.mla,
                                 causal_skip=skip, **kw)
        want, _ = ref_mla.mla_attention(rp, jnp.asarray(x), cfg=rcfg.mla,
                                        causal_skip=skip, **kw)
        _close(y, want)
        return
    tc = mla.make_mla_cache(2, 16, cfg.mla, torch.float32, "cpu")
    rc = ref_mla.make_mla_cache(2, 16, rcfg.mla, jnp.float32)
    x = _x(8, 2, 8, cfg.d_model)
    for xs, ci in ((x, 0), (x[:, :1], 8), (x[:, 1:2], 9)):
        y, tc = mla.mla_attention(tp, torch.as_tensor(xs), cfg=cfg.mla,
                                  cache=tc, cache_index=ci, **kw)
        want, rc = ref_mla.mla_attention(rp, jnp.asarray(xs), cfg=rcfg.mla,
                                         cache=rc, cache_index=jnp.int32(ci),
                                         **kw)
        _close(y, want)
        for k in ("ckv", "kr"):
            _close(tc[k], rc[k])


# ------------------------------------------------------------- Mamba-2 --
def _mamba(seed=9):
    cfg, rcfg = _cfgs("zamba2_1p2b")
    rp, tp = _both(_layer0(golden.serve_params_numpy(cfg, seed)["mamba"]
                           ["mixer"]))
    return cfg, rcfg, rp, tp


@pytest.mark.parametrize("s", [16, 5])
def test_mamba2_chunked_ssd_matches_reference(s):
    """Without a cache: the chunked SSD at s = 16 with chunk 8 (two chunks
    and the carried state), and at s = 5 < chunk (one chunk of 5)."""
    cfg, rcfg, rp, tp = _mamba()
    x = _x(s, 2, s, cfg.d_model)
    y, c = mamba2.mamba2_apply(tp, torch.as_tensor(x), cfg.ssm)
    want, rc = ref_mamba2.mamba2_apply(rp, jnp.asarray(x), rcfg.ssm)
    assert c is None and rc is None
    _close(y, want)


def test_mamba2_cached_recurrence_matches_reference():
    """With a cache (a prefill of 6 tokens, then two decode steps) both
    run the exact per-token recurrence; the conv window and the f32 SSD
    state match leaf by leaf."""
    cfg, rcfg, rp, tp = _mamba(10)
    tc = mamba2.make_mamba_cache(2, cfg.d_model, cfg.ssm, torch.float32,
                                 "cpu")
    rc = ref_mamba2.make_mamba_cache(2, cfg.d_model, rcfg.ssm, jnp.float32)
    assert tc["h"].dtype == torch.float32
    x = _x(11, 2, 6, cfg.d_model)
    ref = jax.jit(lambda p, x, c: ref_mamba2.mamba2_apply(p, x, rcfg.ssm,
                                                          cache=c))
    for xs in (x, x[:, :1], x[:, 1:2]):
        y, tc = mamba2.mamba2_apply(tp, torch.as_tensor(xs), cfg.ssm,
                                    cache=tc)
        want, rc = ref(rp, jnp.asarray(xs), rc)
        _close(y, want)
        for k in ("conv", "h"):
            _close(tc[k], rc[k])


def test_ssd_chunk_scan_asserts_whole_chunks():
    """Both packages refuse a sequence that is not a whole number of
    chunks (s = 12, chunk 8), and neither pads."""
    rng = np.random.default_rng(12)
    xh = rng.standard_normal((1, 12, 2, 4)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (1, 12, 2)).astype(np.float32)
    bc = rng.standard_normal((1, 12, 2, 3)).astype(np.float32)
    with pytest.raises(AssertionError):
        ref_mamba2._ssd_chunk_scan(*map(jnp.asarray, (xh, a, bc, bc)), 8)
    with pytest.raises(AssertionError):
        mamba2._ssd_chunk_scan(*map(torch.as_tensor, (xh, a, bc, bc)), 8)


# --------------------------------------------------------------- xLSTM --
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("cached", [False, True])
def test_xlstm_blocks_match_reference(kind, cached):
    """The mLSTM and sLSTM blocks without a cache, and with one over a
    prefill of 5 tokens and two decode steps (the f32 states leaf by
    leaf)."""
    cfg, _ = _cfgs("xlstm_350m")
    rp, tp = _both(_layer0(golden.serve_params_numpy(cfg, 13)[kind]
                           ["mixer"]))
    apply = {"mlstm": (xlstm.mlstm_apply, ref_xlstm.mlstm_apply),
             "slstm": (xlstm.slstm_apply, ref_xlstm.slstm_apply)}[kind]
    x = _x(14, 2, 5, cfg.d_model)
    if not cached:
        y, _ = apply[0](tp, torch.as_tensor(x), cfg.n_heads)
        want, _ = apply[1](rp, jnp.asarray(x), cfg.n_heads)
        _close(y, want)
        return
    if kind == "mlstm":
        tc = xlstm.make_mlstm_cache(2, cfg.d_model, cfg.n_heads,
                                    device="cpu")
        rc = ref_xlstm.make_mlstm_cache(2, cfg.d_model, cfg.n_heads)
    else:
        tc = xlstm.make_slstm_cache(2, cfg.d_model, device="cpu")
        rc = ref_xlstm.make_slstm_cache(2, cfg.d_model)
    for xs in (x, x[:, :1], x[:, 1:2]):
        y, tc = apply[0](tp, torch.as_tensor(xs), cfg.n_heads, cache=tc)
        want, rc = apply[1](rp, jnp.asarray(xs), cfg.n_heads, cache=rc)
        _close(y, want)
        assert sorted(tc) == sorted(rc)
        for k in tc:
            assert tc[k].dtype == torch.float32
            _close(tc[k], rc[k])


# ------------------------------------------------------------------ lm --
def _inputs(cfg, rng, s):
    """A step's batch: frames for audio, tokens otherwise."""
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((2, s, 512)).astype(
            np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)}


def _leaves_close(got, want):
    """Every leaf of a port cache tree equals the reference's."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        assert tuple(g.shape) == w.shape, path
        _close(g, w)


@pytest.mark.parametrize("arch", FAMILIES + ["zamba2_leftover"])
def test_lm_forward_matches_reference(arch):
    """``lm.forward`` of each reduced family: no cache, then a prefill into
    f32 caches (for the VLM, patches before the tokens) and two decode
    steps.  ``zamba2_leftover`` is the hybrid at 5 layers: two runs of 2
    Mamba-2 layers, each with the shared attention, then one leftover
    layer."""
    over = {}
    if arch == "zamba2_leftover":
        arch, over = "zamba2_1p2b", dict(n_layers=5)
    cfg, rcfg = _cfgs(arch, **over)
    tree = golden.serve_params_numpy(cfg, 15)
    rp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, cfg,
                                                                "cpu")
    rng = np.random.default_rng(16)
    first = _inputs(cfg, rng, 8)     # a whole SSD chunk for Zamba2
    if cfg.frontend == "vision":
        first["patches"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.d_frontend)).astype(np.float32)

    # jitted: the eager reference compiles each scan body on every call
    ref_fwd = jax.jit(lambda p, b, c, ci: ref_lm.forward(
        p, rcfg, b, caches=c, cache_index=ci))

    def run(batch, rc=None, tc=None, at=None):
        want, rc, waux = ref_fwd(
            rp, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
            None if rc is None else jnp.int32(at))
        got, tc, gaux = lm.forward(
            tp, cfg, {k: torch.as_tensor(v) for k, v in batch.items()},
            **({} if tc is None else dict(caches=tc, cache_index=at)))
        _close(got, want)
        _close(gaux, waux)
        return rc, tc

    run(first)
    rc = ref_lm.make_caches(rcfg, 2, 48, dtype=jnp.float32)
    tc = lm.make_caches(cfg, 2, 48, dtype=torch.float32, device="cpu")
    ci = 8 + (cfg.n_patches if "patches" in first else 0)
    steps = [(first, 0)] + [(_inputs(cfg, rng, 1), ci + i) for i in (0, 1)]
    for batch, at in steps:
        rc, tc = run(batch, rc, tc, at)
        _leaves_close(tc, rc)


def _port_leaves(params: lm.LM) -> dict:
    """``{path: (shape, dtype name)}`` of the port's tree with each group
    stacked, as the reference's pytree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for k in t[0]:
                vals = [b[k] for b in t]
                if isinstance(vals[0], dict):
                    walk(vals, path + (k,))
                else:
                    assert all(v.shape == vals[0].shape and
                               v.dtype == vals[0].dtype for v in vals)
                    out[path + (k,)] = ((len(vals),) + tuple(vals[0].shape),
                                        str(vals[0].dtype)[6:])
        else:
            out[path] = (tuple(t.shape), str(t.dtype)[6:])
    for k, v in params.tree().items():
        walk(v, (k,))
    return out


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_init_params_and_convert_match_reference(arch):
    """For every config (reduced): ``init_params`` has the reference's
    ``shape_params`` tree, shapes and dtypes (bf16 weights; f32 norms,
    router, xLSTM gate weights and Mamba-2 decay parameters) on the
    generator's device; the golden parameter draw has the reference's
    layout; and ``params_from_numpy`` / ``params_to_numpy`` carry it
    across and back bit for bit."""
    cfg, rcfg = _cfgs(arch)
    got = lm.init_params(cfg, torch.Generator(device="cpu").manual_seed(0))
    want = {tuple(k.key for k in path): (leaf.shape, leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                ref_lm.shape_params(rcfg))}
    assert _port_leaves(got) == want
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in got.parameters())
    tree = golden.serve_params_numpy(cfg, 17)
    assert {tuple(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)} == \
        {k: v[0] for k, v in want.items()}
    back = params_to_numpy(params_from_numpy(tree, cfg, "cpu"))
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), back, tree)


def test_forward_without_a_family_group_is_refused():
    cfg, _ = _cfgs("xlstm_350m")
    tree = golden.serve_params_numpy(cfg, 0)
    del tree["slstm"]
    with pytest.raises(ValueError, match="slstm"):
        params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_350m"])
def test_checkpoints_cross_packages_in_reference_layout(tmp_path, arch):
    """A reduced Zamba2 / xLSTM parameter tree saved by the reference
    (``init_params``: bf16 weights, f32 norms and gates) restores in the
    port's store and builds the port's model, and the port's tree saved
    in the reference's layout (``params_to_numpy``) restores in the
    reference's store, each with equal bits."""
    cfg, rcfg = _cfgs(arch)
    ref_tree = jax.jit(lambda: ref_lm.init_params(rcfg,
                                                  jax.random.PRNGKey(3)))()
    ref_store.save_checkpoint(str(tmp_path / "ref"), 4, ref_tree)
    like = jax.tree.map(
        lambda a: torch.zeros(a.shape, dtype=getattr(torch, a.dtype.name)),
        ref_tree)
    got, step, _ = restore_checkpoint(str(tmp_path / "ref"), like,
                                      device="cpu")
    assert step == 4
    params = params_from_numpy(got, cfg, "cpu")
    back = params_to_numpy(params)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(
        g, np.asarray(w, np.float32)), back, ref_tree)
    for (path, w), t in zip(jax.tree_util.tree_leaves_with_path(ref_tree),
                            jax.tree.leaves(got)):
        assert str(t.dtype)[6:] == w.dtype.name, path
    # the port's tree, in the reference's layout, read by the reference
    tree = golden.serve_params_numpy(cfg, 18)
    save_checkpoint(str(tmp_path / "port"), 6,
                    params_to_numpy(params_from_numpy(tree, cfg, "cpu")))
    rback, step, _ = ref_store.restore_checkpoint(
        str(tmp_path / "port"), jax.tree.map(jnp.asarray, tree))
    assert step == 6
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(np.asarray(g), w),
                 rback, tree)
