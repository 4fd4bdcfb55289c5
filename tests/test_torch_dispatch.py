"""The port's active-message dispatch (``repro_torch.sparse.dispatch``)
against the reference's ``repro.sparse.dispatch`` on the same seeded
inputs: the bucketing bit for bit (dead items, overflow, capacity 1, and
the reference's own test cases, ``tests/test_sparse.py``); the
multi-device half over shards of the CPU (each shard's routing bit-equal
to the reference's ``bucketize`` / ``steal_overflow``, the round trip,
``shard_csr_rows`` byte for byte, ``spmv_sharded`` against ``a @ x``);
the mesh and its collectives; and ``psum_compressed`` against the
reference's ``compress_tree``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sparse import dispatch as ref  # noqa: E402
from repro.train import compress as ref_compress  # noqa: E402

from repro_torch.bench import multidevice  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import sparse_dispatch  # noqa: E402
from repro_torch.sparse import dispatch  # noqa: E402
from repro_torch.train import compress  # noqa: E402

CPU = torch.device("cpu")


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


# ----------------------------------------------------------------------------
# the mesh and its collectives
# ----------------------------------------------------------------------------
def test_host_mesh_shape_and_devices():
    """``make_host_mesh`` over repeated CPU devices: the reference's
    ``(data, model)`` axes, ``shape`` an ordered name -> size map,
    ``devices_along``; too few devices and a device that does not exist
    raise, and so does the production mesh without its 256 cards."""
    m = mesh_mod.make_host_mesh(4, 2, devices=[CPU] * 8)
    assert list(m.shape.items()) == [("data", 4), ("model", 2)]
    assert m.size == 8 and m.devices.shape == (4, 2)
    assert m.devices_along("data") == [CPU] * 4
    assert m.devices_along("model") == [CPU] * 2
    with pytest.raises(RuntimeError, match="8 devices needed"):
        mesh_mod.make_host_mesh(4, 2, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="does not exist"):
        mesh_mod.make_host_mesh(
            2, 1, devices=[CPU, f"cuda:{torch.cuda.device_count()}"])
    with pytest.raises(RuntimeError, match="256 devices needed"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 devices needed"):
        mesh_mod.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="no axis"):
        m.devices_along("pod")


def test_all_to_all_and_psum_semantics():
    """The tiled all-to-all gives shard d the d-th piece of every shard in
    shard order, and psum the sum in shard order; every output owns its
    memory (shards on one device never alias)."""
    s = 4
    m = mesh_mod.make_host_mesh(s, 1, devices=[CPU] * s)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal((s * 2, 3)).astype(np.float32))
          for _ in range(s)]
    out = mesh_mod.all_to_all(xs, m, "data")
    for d in range(s):
        want = np.concatenate([x.numpy()[2 * d:2 * d + 2] for x in xs])
        np.testing.assert_array_equal(out[d].numpy(), want)
    sums = mesh_mod.psum(xs, m, "data")
    want = ((xs[0].numpy() + xs[1].numpy()) + xs[2].numpy()) + xs[3].numpy()
    for d in range(s):
        np.testing.assert_array_equal(sums[d].numpy(), want)
    ptrs = {t.data_ptr() for t in out + sums + xs}
    assert len(ptrs) == 3 * s
    with pytest.raises(ValueError, match="shards for axis"):
        mesh_mod.psum(xs[:3], m, "data")
    with pytest.raises(ValueError, match="does not split"):
        mesh_mod.all_to_all([x[:3] for x in xs], m, "data")


# ----------------------------------------------------------------------------
# the multi-device half: am_dispatch / am_respond
# ----------------------------------------------------------------------------
def _shard_dests(n_shards: int, length: int, seed: int) -> list:
    """Per-shard destinations, skewed toward shard 0, a fifth dead."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_shards):
        d = np.minimum(rng.geometric(0.45, size=length) - 1,
                       n_shards - 1).astype(np.int32)
        d[rng.random(length) < 0.2] = -1
        out.append(d)
    return out


@pytest.mark.parametrize("n_shards,capacity,opportunistic",
                         [(4, 3, False), (4, 3, True), (8, 2, True),
                          (2, 16, False)])
def test_am_dispatch_routing_bit_equal(n_shards, capacity, opportunistic):
    """Each shard's routing is the reference's on that shard's ``dest``:
    with ``opportunistic``, ``steal_overflow`` against the psum of every
    shard's histogram of live destinations (the reference's
    ``segment_sum``); then ``bucketize``.  The received payloads are the
    reference's buckets exchanged shard to shard, and ``valid`` arrives
    as bool."""
    length = 12
    dests = _shard_dests(n_shards, length, seed=n_shards * 10 + capacity)
    rng = np.random.default_rng(1)
    vals = [rng.standard_normal((length, 2)).astype(np.float32)
            for _ in range(n_shards)]
    tags = [np.arange(length, dtype=np.int32) + 100 * s
            for s in range(n_shards)]
    m = mesh_mod.make_host_mesh(n_shards, 1, devices=[CPU] * n_shards)
    items = [{"val": torch.as_tensor(v), "tag": torch.as_tensor(t)}
             for v, t in zip(vals, tags)]
    recv, rvalid, meta = dispatch.am_dispatch(
        items, [torch.as_tensor(d) for d in dests], mesh=m, axis="data",
        capacity=capacity, opportunistic=opportunistic)
    if opportunistic:
        hists = [jax.ops.segment_sum(
            jnp.where(jnp.asarray(d) >= 0, 1, 0),
            jnp.clip(jnp.asarray(d), 0), num_segments=n_shards)
            for d in dests]
        load = sum(hists[1:], hists[0])
        ref_dests = [ref.steal_overflow(jnp.asarray(d), load, capacity)
                     for d in dests]
    else:
        ref_dests = [jnp.asarray(d) for d in dests]
    routes = [ref.bucketize(d, n_shards, capacity) for d in ref_dests]
    for s in range(n_shards):
        got_dest, got_rank, got_kept = meta[s]
        _equal(got_dest, ref_dests[s])
        _equal(got_rank, routes[s][2])
        _equal(got_kept, routes[s][3])
    for d in range(n_shards):
        assert rvalid[d].dtype == torch.bool
        for s in range(n_shards):
            idx, valid = (np.asarray(a) for a in routes[s][:2])
            np.testing.assert_array_equal(rvalid[d][s].numpy(), valid[d])
            want_val = np.where(valid[d][:, None], vals[s][idx[d]], 0)
            want_tag = np.where(valid[d], tags[s][idx[d]], 0)
            np.testing.assert_array_equal(recv[d]["val"][s].numpy(),
                                          want_val)
            np.testing.assert_array_equal(recv[d]["tag"][s].numpy(),
                                          want_tag)


@pytest.mark.parametrize("n_shards,capacity", [(4, 2), (4, 12), (8, 1)])
def test_am_round_trip_returns_kept_payloads(n_shards, capacity):
    """``am_dispatch`` then ``am_respond`` of the received payloads: every
    kept item gets its own payload back, every dropped or dead item the
    fill (0)."""
    length = 10
    dests = _shard_dests(n_shards, length, seed=capacity)
    rng = np.random.default_rng(7)
    vals = [rng.standard_normal((length, 3)).astype(np.float32) + 5
            for _ in range(n_shards)]
    m = mesh_mod.make_host_mesh(n_shards, 1, devices=[CPU] * n_shards)
    recv, _, meta = dispatch.am_dispatch(
        [torch.as_tensor(v) for v in vals],
        [torch.as_tensor(d) for d in dests], mesh=m, axis="data",
        capacity=capacity)
    back = dispatch.am_respond(recv, meta, mesh=m, axis="data")
    dropped = 0
    for s in range(n_shards):
        kept = meta[s][2].numpy()
        dropped += int(((dests[s] >= 0) & ~kept).sum())
        np.testing.assert_array_equal(
            back[s].numpy(), np.where(kept[:, None], vals[s], 0))
    if capacity < length:
        assert dropped > 0


# ----------------------------------------------------------------------------
# shard_csr_rows and spmv_sharded
# ----------------------------------------------------------------------------
def _skewed(m: int, n: int, seed: int, dtype=np.float32) -> np.ndarray:
    """``tests/test_sparse.py``'s multi-device matrix: row i of density
    0.02 + (i mod 7) * 0.12, at most 0.9."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n), dtype)
    for i in range(m):
        d = min(0.9, 0.02 + (i % 7) * 0.12)
        a[i] = (rng.random(n) < d) * rng.standard_normal(n)
    return a


@pytest.mark.parametrize("m,n,n_shards,nnz_cap,dtype",
                         [(64, 64, 8, None, np.float32),
                          (24, 24, 1, None, np.float32),
                          (40, 33, 4, 200, np.float32),
                          (30, 16, 3, None, np.float64)])
def test_shard_csr_rows_byte_equal(m, n, n_shards, nnz_cap, dtype):
    """The port's numpy ``shard_csr_rows`` returns the reference's dict:
    the same keys, types, dtypes and bytes (an explicit ``nnz_cap``
    too)."""
    a = _skewed(m, n, seed=m + n_shards, dtype=dtype)
    want = ref.shard_csr_rows(a, n_shards, nnz_cap=nnz_cap)
    got = dispatch.shard_csr_rows(a, n_shards, nnz_cap=nnz_cap)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        if isinstance(w, np.ndarray):
            assert (g.dtype, g.shape) == (w.dtype, w.shape), k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert g == w, k


@pytest.mark.parametrize("opportunistic", [False, True])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_spmv_sharded_matches_dense(n_shards, opportunistic):
    """The T1/T2/T3 flow over 1, 4 and 8 CPU shards within the reference
    test's 1e-4 of ``a @ x`` (its own multi-device matrix), with
    stealing a no-op at the worst bucket's capacity."""
    a = _skewed(64, 64, seed=1)
    x = np.random.default_rng(2).standard_normal(64).astype(np.float32)
    m = mesh_mod.make_host_mesh(n_shards, 1, devices=[CPU] * n_shards)
    sh = dispatch.shard_csr_rows(a, n_shards)
    y = dispatch.spmv_sharded(m, sh, x, capacity=int(sh["cap"]),
                              opportunistic=opportunistic)
    assert y.shape == (64,) and y.dtype == np.float32
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-4)


def test_sparse_dispatch_script_runs_on_cpu(capsys):
    """``python -m repro_torch.launch.sparse_dispatch --devices cpu``: the
    example's 512 x 512 power-law matrix over 8 CPU shards, nnz-balanced
    rows at least as even as equal rows, within 1e-3 of ``a @ x``."""
    assert sparse_dispatch.main(["--devices", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "8 shards" in out and "OK" in out
    res = sparse_dispatch.run(64, ("cpu",), verbose=False)
    assert res["max_abs_err"] < sparse_dispatch.TOL
    loads = res["loads"]
    assert loads["nnz-balanced"].max() <= loads["equal-rows"].max()
    assert loads["nnz-balanced"].sum() == res["nnz"]


# ----------------------------------------------------------------------------
# psum_compressed
# ----------------------------------------------------------------------------
def test_psum_compressed_matches_reference():
    """Each shard compresses its own gradients plus error feedback (the
    reference's ``compress_tree``, bit for bit on the new error) and every
    shard receives the sum over shards of the dequantized payloads, within
    1e-6 relative of the float64 sum of the reference's."""
    n_shards = 4
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 8), "b": (8,), "blocks": {"a": (4, 4, 3)}}

    def tree(scale):
        return {"w": rng.standard_normal(shapes["w"]).astype(np.float32)
                * scale,
                "b": rng.standard_normal(shapes["b"]).astype(np.float32),
                "blocks": {"a": rng.standard_normal(
                    shapes["blocks"]["a"]).astype(np.float32)}}

    grads = [tree(1.0 + s) for s in range(n_shards)]
    errors = [jax.tree.map(lambda g: g * 1e-3, tree(1.0))
              for _ in range(n_shards)]
    errors[0] = None
    m = mesh_mod.make_host_mesh(n_shards, 1, devices=[CPU] * n_shards)
    t = lambda tr: None if tr is None else jax.tree.map(  # noqa: E731
        torch.as_tensor, tr)
    summed, new_err = compress.psum_compressed(
        [t(g) for g in grads], [t(e) for e in errors], mesh=m, axis="data")
    refs = [ref_compress.compress_tree(
        jax.tree.map(jnp.asarray, g),
        None if e is None else jax.tree.map(jnp.asarray, e))
        for g, e in zip(grads, errors)]
    want = jax.tree.map(
        lambda *leaves: sum(np.asarray(x, np.float64) for x in leaves),
        *[jax.tree.map(lambda q, sc: np.asarray(
            ref_compress.dequantize(q, sc), np.float64), p, sc)
          for p, sc, _ in refs])
    for s in range(n_shards):
        got = jax.tree.map(lambda x: x.numpy(), summed[s])
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for gl, wl in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert gl.dtype == np.float32
            np.testing.assert_allclose(gl, wl, rtol=1e-6, atol=1e-6)
        for gl, wl in zip(jax.tree.leaves(jax.tree.map(
                lambda x: x.numpy(), new_err[s])),
                jax.tree.leaves(refs[s][2])):
            _equal(gl, wl)


def test_multidevice_dispatch_legs_on_cpu():
    """The card's ``[dispatch]`` legs (``bench.multidevice.run_dispatch``)
    at a small size on CPU shards: every check they make holds, and
    stealing at the worst bucket's capacity moves fewer bytes."""
    import dataclasses
    small = dataclasses.replace(multidevice.CFG_100M, n_layers=2, d_model=64,
                                n_heads=2, n_kv=1, d_ff=128, vocab=512,
                                head_dim=32)
    rows = multidevice.run_dispatch([CPU] * 8, [CPU] * 4, n=256,
                                    psum_cfg=small, verbose=False)
    spmv, psum = rows["spmv"], rows["psum"]
    assert spmv["plain"]["max_abs_err"] < 1e-4
    assert spmv["opportunistic"]["capacity"] == spmv["worst_bucket"]
    assert spmv["opportunistic"]["all_to_all_bytes"] < \
        spmv["plain"]["all_to_all_bytes"]
    assert psum["max_err_over_magnitudes"] <= multidevice.PSUM_TOL
    params = multidevice.lm.init_params(small, torch.Generator(),
                                        dtype=torch.float32)
    assert psum["numel"] == sum(p.numel() for p in params.parameters())
