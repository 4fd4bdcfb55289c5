"""The port's active-message bucketing (``repro_torch.sparse.dispatch``)
bit-equal to the reference's ``repro.sparse.dispatch`` on the same
seeded inputs: dead items, overflow, capacity 1, and the reference's own
test cases (``tests/test_sparse.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sparse import dispatch as ref  # noqa: E402

from repro_torch.sparse import dispatch  # noqa: E402


def _dest(case: str) -> tuple[np.ndarray, int, int]:
    """(dest, n_shards, capacity) of a named case."""
    rng = np.random.default_rng(len(case))
    if case == "roundtrip":                 # test_sparse.py: 33 items, room
        return rng.integers(0, 4, size=(33,)).astype(np.int32), 4, 16
    if case == "all_to_one":                # test_sparse.py: backpressure
        return np.zeros((10,), np.int32), 2, 4
    if case == "dead_items":
        d = rng.integers(0, 5, size=(40,)).astype(np.int32)
        d[rng.random(40) < 0.3] = -1
        return d, 5, 6
    if case == "overflow":
        return rng.integers(0, 3, size=(64,)).astype(np.int32), 3, 9
    if case == "capacity_1":
        d = rng.integers(0, 8, size=(24,)).astype(np.int32)
        d[::5] = -1
        return d, 8, 1
    if case == "all_dead":
        return np.full((7,), -1, np.int32), 3, 2
    raise KeyError(case)


CASES = ["roundtrip", "all_to_one", "dead_items", "overflow", "capacity_1",
         "all_dead"]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_bucketize_bit_equal(case):
    dest, s, cap = _dest(case)
    want = ref.bucketize(jnp.asarray(dest), s, cap)
    got = dispatch.bucketize(torch.as_tensor(dest), s, cap)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("case", CASES)
def test_unbucketize_bit_equal(case):
    """Per-item results back from the buckets, 1-D and 2-D payloads, with
    the default fill and another."""
    dest, s, cap = _dest(case)
    rng = np.random.default_rng(5)
    idx, valid, rank, kept = ref.bucketize(jnp.asarray(dest), s, cap)
    t_idx, t_valid, t_rank, t_kept = dispatch.bucketize(
        torch.as_tensor(dest), s, cap)
    for shape in ((s, cap), (s, cap, 3)):
        vals = rng.standard_normal(shape).astype(np.float32)
        for fill in (0, -2.5):
            want = ref.unbucketize(jnp.asarray(vals), jnp.asarray(dest),
                                   rank, kept, fill=fill)
            got = dispatch.unbucketize(torch.as_tensor(vals),
                                       torch.as_tensor(dest), t_rank,
                                       t_kept, fill=fill)
            _equal(got, want)


def test_bucketize_roundtrip_and_backpressure():
    """The reference tests' properties hold on the port: a round trip
    returns every item; an overfull bucket keeps exactly its capacity."""
    dest, s, cap = _dest("roundtrip")
    vals = torch.as_tensor(np.random.default_rng(2).standard_normal(33),
                           dtype=torch.float32)
    idx, valid, rank, kept = dispatch.bucketize(torch.as_tensor(dest), s,
                                                cap)
    assert bool(kept.all())
    picked = torch.where(valid, vals[idx.long()], 0)
    back = dispatch.unbucketize(picked, torch.as_tensor(dest), rank, kept)
    torch.testing.assert_close(back, vals, rtol=0, atol=0)
    dest, s, cap = _dest("all_to_one")
    _, valid, _, kept = dispatch.bucketize(torch.as_tensor(dest), s, cap)
    assert int(kept.sum()) == 4 and int(valid.sum()) == 4


@pytest.mark.parametrize("case", CASES + ["steal_idle"])
def test_steal_overflow_bit_equal(case):
    """Overflow re-routing equal to the reference, with the load the MoE
    layer passes (the histogram of live destinations) and, for the
    reference test's case, its hand-written global load."""
    if case == "steal_idle":                # test_sparse.py
        dest, s, cap = np.zeros((12,), np.int32), 4, 4
        load = np.asarray([12, 0, 0, 0], np.int32)
    else:
        dest, s, cap = _dest(case)
        load = np.bincount(dest[dest >= 0], minlength=s).astype(np.int32)
    want = ref.steal_overflow(jnp.asarray(dest), jnp.asarray(load), cap)
    got = dispatch.steal_overflow(torch.as_tensor(dest),
                                  torch.as_tensor(load), cap)
    _equal(got, want)
    if case == "steal_idle":
        counts = np.bincount(got.numpy(), minlength=4)
        assert counts[0] == 4 and counts[1:].sum() == 8
        assert counts.max() <= 4
