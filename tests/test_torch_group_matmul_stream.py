"""The weight stream's work plan (``repro_torch.kernels.group_matmul``,
``stream_plan``): every serving call's tiles of at most 16 rows are cut
into (tile, 128-column block) units of ring stages, and one CTA a
streaming multiprocessor takes an equal share of all the stages in order.
Held here to its contract at the serving shapes of Phi-3.5-MoE and
DeepSeek-V2-Lite (whole, and a ``[mesh]`` rank's experts), and at tile_m
1-16 with d from 8 to 6400; and the sum it implies (each unit's shares
added in the contraction's order) against the reference kernel in
interpret mode.  The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import group_matmul as ref_group_matmul  # noqa: E402

from repro_torch.kernels.group_matmul import (  # noqa: E402
    STREAM_BK, STREAM_BN, call_token, stream_plan, stream_workspace)

#: the serving rows: experts (one 8-row tile each, decode and prefill), d, f
SERVING = {
    "phi_wg": (16, 4096, 6400), "phi_wo": (16, 6400, 4096),
    "phi_mesh_wg": (8, 4096, 6400), "phi_mesh_wo": (8, 6400, 4096),
    "deepseek_wg": (64, 2048, 1408), "deepseek_wo": (64, 1408, 2048),
    "deepseek_mesh_wg": (32, 2048, 1408), "deepseek_mesh_wo": (32, 1408, 2048),
}
H100_SMS = 132


def check_plan(plan, d: int, n_sms: int) -> None:
    """The contract: at least one CTA an SM; each CTA's stages an equal
    share (within one); each unit's shares cover its stages, so its d
    rows, once, in order, each share non-empty; a CTA's first and last
    unit are the only ones it may share (slots 0 and 1), every other it
    covers whole; the workspace holds every slot and a counter a unit."""
    assert plan.ctas >= n_sms
    counts = [plan.first(i + 1) - plan.first(i) for i in range(plan.ctas)]
    assert sum(counts) == plan.steps
    assert max(counts) - min(counts) <= 1
    by_unit: dict = {}
    slots = set()
    for cta, unit, lo, hi, slot in plan.segments():
        assert 0 <= lo < hi <= plan.k_steps
        # in rows of w: [lo bk, min(hi bk, d)), non-empty
        assert lo * plan.bk < min(hi * plan.bk, d)
        by_unit.setdefault(unit, []).append((cta, lo, hi, slot))
        if slot is not None:
            assert (cta, slot) not in slots
            slots.add((cta, slot))
    assert sorted(by_unit) == list(range(plan.units))
    for unit, shares in by_unit.items():
        assert [c for c, *_ in shares] == sorted(c for c, *_ in shares)
        assert shares[0][1] == 0 and shares[-1][2] == plan.k_steps
        for (_, _, hi, _), (_, lo, _, _) in zip(shares, shares[1:]):
            assert hi == lo
        if len(shares) == 1:
            assert shares[0][3] is None
        else:
            assert all(s is not None for *_, s in shares)
    part = plan.rows * STREAM_BN * 4
    assert plan.workspace_bytes == plan.ctas * 2 * part + plan.units * 8
    assert all((cta * 2 + slot + 1) * part <= plan.ctas * 2 * part
               for cta, slot in slots)
    # what the CUDA wrapper allocates for the launch
    ws = stream_workspace(plan, "cpu")
    assert ws.dtype == torch.uint8 and ws.numel() == plan.workspace_bytes


@pytest.mark.parametrize("n_sms", [H100_SMS, 114])
@pytest.mark.parametrize("name", list(SERVING))
def test_stream_plan_at_serving_shapes(name, n_sms):
    e, d, f = SERVING[name]
    plan = stream_plan(e, 8, d, f, n_sms, 2)
    check_plan(plan, d, n_sms)
    assert plan.rows == 8 and plan.bk == STREAM_BK[2] == 64
    # 128 columns divide every serving width: no column block is partial
    assert f % STREAM_BN == 0 and plan.units == e * f // STREAM_BN
    # every CTA streams: more stages than SMs at each of these shapes
    assert plan.steps >= plan.ctas and plan.first(1) > 0


@pytest.mark.parametrize("d", [8, 64, 1000, 2048, 4096, 6400])
@pytest.mark.parametrize("tile_m", range(1, 17))
def test_stream_plan_at_every_tile_height(tile_m, d):
    for dtype_size in (2, 4):
        plan = stream_plan(3, tile_m, d, 200, H100_SMS, dtype_size)
        check_plan(plan, d, H100_SMS)
        assert plan.rows == (8 if tile_m <= 8 else 16)
        assert plan.k_steps == -(-d // STREAM_BK[dtype_size])


def test_call_tokens_are_distinct_and_fit_the_counter():
    """Each launch's token is new, nonzero and under 2^48 (the counter's
    top 48 bits), with its salt in the top 16 of them."""
    tokens = [call_token() for _ in range(1000)]
    assert len(set(tokens)) == len(tokens)
    assert all(0 < t < 1 << 48 and t >> 32 for t in tokens)
    assert len({t >> 32 for t in tokens}) == 1


def test_stream_plan_refuses_wide_tiles():
    with pytest.raises(ValueError, match="tile_m 1-16"):
        stream_plan(4, 17, 64, 64, H100_SMS, 2)


def _split_sum(x, eid, w, tile_m, plan):
    """The product as the kernel forms it: each unit's shares summed over
    their rows of d in f32, then added in the contraction's order (a unit
    of one share is that share); out-of-range ids give NaN rows."""
    t, d = x.shape
    f = w.shape[2]
    n_cb = -(-f // STREAM_BN)
    out = np.zeros((t, f), np.float32)
    sums: dict = {}
    for _, unit, lo, hi, _ in plan.segments():
        tile, cb = divmod(unit, n_cb)
        cols = slice(cb * STREAM_BN, min(f, (cb + 1) * STREAM_BN))
        rows = slice(tile * tile_m, (tile + 1) * tile_m)
        ks = slice(lo * plan.bk, min(hi * plan.bk, d))
        e = int(eid[tile])
        if not 0 <= e < w.shape[0]:
            sums[unit] = np.full((tile_m, cols.stop - cols.start), np.nan,
                                 np.float32)
            continue
        share = x[rows, ks] @ w[e][ks, cols]
        sums[unit] = share if unit not in sums else sums[unit] + share
    for unit, val in sums.items():
        tile, cb = divmod(unit, n_cb)
        out[tile * tile_m:(tile + 1) * tile_m,
            cb * STREAM_BN:min(f, (cb + 1) * STREAM_BN)] = val
    return out


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiles,tile_m,d,f,e,n_sms", [
    (4, 1, 96, 200, 3, 7),      # units cut over several CTAs
    (3, 8, 200, 136, 2, 5),     # a CTA's first and last unit shares
    (2, 16, 72, 264, 2, 3),     # R = 16, d not a multiple of a stage
    (3, 13, 130, 72, 3, 40),    # more CTAs than stages
])
def test_stream_split_sum_matches_reference(tiles, tile_m, d, f, e, n_sms,
                                            dtype_name):
    """The plan's sum of shares equals the reference kernel (interpret
    mode) within the reference kernel tests' tolerances: f32 1e-5 (only
    the order of the sum differs), bf16 2e-2 (both widen the same bf16
    values, whose products are exact in f32)."""
    rng = np.random.default_rng(tiles * 100 + tile_m + d)
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    x = rng.standard_normal((tiles * tile_m, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    eid = rng.integers(0, e, tiles).astype(np.int32)
    # the operands both sides see (bf16 values held in f32)
    xq = np.asarray(jnp.asarray(x).astype(jdt), np.float32)
    wq = np.asarray(jnp.asarray(w).astype(jdt), np.float32)
    plan = stream_plan(tiles, tile_m, d, f, n_sms,
                       2 if dtype_name == "bfloat16" else 4)
    check_plan(plan, d, n_sms)
    got = _split_sum(xq, eid, wq, tile_m, plan)
    want = np.asarray(ref_group_matmul(
        jnp.asarray(x).astype(jdt), jnp.asarray(eid),
        jnp.asarray(w).astype(jdt), tile_m=tile_m, interpret=True),
        np.float32)
    tol = 1e-5 if dtype_name == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_stream_split_sum_marks_bad_ids():
    """A tile whose expert id is out of range is NaN whatever its shares."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3 * 8, 64)).astype(np.float32)
    w = rng.standard_normal((2, 64, 136)).astype(np.float32)
    eid = np.array([0, 5, 1], np.int32)
    plan = stream_plan(3, 8, 64, 136, 4, 4)
    got = _split_sum(x, eid, w, 8, plan)
    assert np.isnan(got[8:16]).all() and not np.isnan(got[:8]).any()
    np.testing.assert_allclose(got[16:], x[16:] @ w[1], rtol=1e-5,
                               atol=1e-5)
