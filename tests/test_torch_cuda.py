"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so it runs on a machine with a card and
without JAX::

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (bcsr_spmm, bcsr_spmm_plain,  # noqa: E402
                                 group_matmul, group_matmul_plain,
                                 grouped_expert_matmul, sddmm_blocks,
                                 sddmm_blocks_plain)
from repro_torch.bench import kernels as bench_kernels  # noqa: E402
from repro_torch.sparse.formats import BCSR  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    """On the card: both kernels against their plain versions at the
    reference test shapes, edge cases included."""
    rng = np.random.default_rng(0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for (m, n, k, block, density, cap) in [
            (32, 64, 16, (8, 16), 0.3, None), (64, 64, 128, (16, 16), 0.15,
                                               None),
            (16, 128, 256, (8, 128), 0.5, None), (128, 256, 100, (8, 128),
                                                  0.05, 64),
            (64, 32, 16, (8, 16), 0.0, None)]:
        a_dense = np.where(rng.random((m, n)) < density,
                           rng.standard_normal((m, n)), 0).astype(np.float32)
        a = BCSR.from_dense(a_dense, block=block, cap=cap, dtype=dtype,
                            device=cuda_device)
        b = torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype,
                            device=cuda_device)
        got = bcsr_spmm(a, b)
        torch.testing.assert_close(got, bcsr_spmm_plain(a, b), rtol=tol,
                                   atol=tol)
    for (m, d, n, bm, bn, dk, nblk, live) in [
            (32, 64, 32, 8, 8, 16, 7, None), (64, 128, 64, 16, 16, 128, 12,
                                               None),
            (16, 100, 16, 8, 8, 128, 4, 2)]:
        a = torch.as_tensor(rng.standard_normal((m, d)), dtype=dtype,
                            device=cuda_device)
        b = torch.as_tensor(rng.standard_normal((d, n)), dtype=dtype,
                            device=cuda_device)
        brow = torch.as_tensor(rng.integers(0, m // bm, nblk),
                               dtype=torch.int32, device=cuda_device)
        bcol = torch.as_tensor(rng.integers(0, n // bn, nblk),
                               dtype=torch.int32, device=cuda_device)
        got = sddmm_blocks(brow, bcol, a, b, bm=bm, bn=bn, dk=dk,
                           n_blocks=live)
        torch.testing.assert_close(
            got, sddmm_blocks_plain(brow, bcol, a, b, bm=bm, bn=bn,
                                    n_blocks=live), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiles,tile_m,d,f,e", [
    (4, 8, 32, 64, 3), (8, 16, 128, 128, 4), (2, 8, 100, 72, 2),
    (6, 32, 96, 200, 3), (3, 128, 130, 70, 2), (2, 100, 33, 65, 3),
    (5, 24, 17, 9, 2), (3, 10, 513, 33, 2), (16, 8, 600, 130, 16),
    (3, 4, 300, 66, 2)])
def test_cuda_group_matmul_matches_plain(cuda_device, dtype, tiles, tile_m,
                                         d, f, e):
    """The grouped-matmul kernel against its plain version: both CTA
    shapes (weight-streaming for tile_m 4, 8, 10, 16; tiled for 24, 32,
    100, 128), unaligned d / f, d past one staged slice, and a kernel
    launch counted once per call."""
    rng = np.random.default_rng(tiles * tile_m + d + f)
    # f32: the reference kernel tests' 1e-5 at their contraction depths
    # (d <= 128); past that the two summation orders drift further apart,
    # and the reference benchmark's 1e-4 applies
    tol = (1e-5 if d <= 128 else 1e-4) if dtype == torch.float32 else 2e-2
    x = torch.as_tensor(rng.standard_normal((tiles * tile_m, d)),
                        dtype=dtype, device=cuda_device)
    w = torch.as_tensor(rng.standard_normal((e, d, f)), dtype=dtype,
                        device=cuda_device)
    eid = torch.as_tensor(rng.integers(0, e, tiles), dtype=torch.int32,
                          device=cuda_device)
    before = group_matmul.launches
    got = group_matmul(x, eid, w, tile_m=tile_m)
    torch.cuda.synchronize()
    assert group_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (tiles * tile_m, f)
    torch.testing.assert_close(
        got, group_matmul_plain(x, eid, w, tile_m=tile_m), rtol=tol,
        atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_group_matmul_operator(cuda_device, dtype):
    """``torch.ops.repro_torch.group_matmul`` on CUDA tensors launches the
    kernel once (the launch count grows by one) and matches the plain
    version at the kernel tests' tolerances; on fake tensors of the same
    shapes it launches nothing and gives the real result's shape, dtype
    and device, and the dry run's counter gives the real launch and the
    fake call the same FLOPs (the formula's 2 t d f) and eager bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import roofline as rl
    rng = np.random.default_rng(7)
    tiles, tile_m, d, f, e = 6, 16, 96, 80, 3
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    x = torch.as_tensor(rng.standard_normal((tiles * tile_m, d)),
                        dtype=dtype, device=cuda_device)
    w = torch.as_tensor(rng.standard_normal((e, d, f)), dtype=dtype,
                        device=cuda_device)
    eid = torch.as_tensor(rng.integers(0, e, tiles), dtype=torch.int32,
                          device=cuda_device)
    before = group_matmul.launches
    with rl.Counter() as real:
        got = torch.ops.repro_torch.group_matmul(x, eid, w, tile_m)
    torch.cuda.synchronize()
    assert group_matmul.launches == before + 1
    torch.testing.assert_close(
        got, group_matmul_plain(x, eid, w, tile_m=tile_m), rtol=tol,
        atol=tol)
    with FakeTensorMode() as mode:
        fx, feid, fw = (mode.from_tensor(t) for t in (x, eid, w))
        with rl.Counter() as fake:
            out = torch.ops.repro_torch.group_matmul(fx, feid, fw, tile_m)
    assert group_matmul.launches == before + 1
    assert (out.shape, out.dtype, out.device) == (got.shape, got.dtype,
                                                  got.device)
    assert real.flops == fake.flops == 2 * tiles * tile_m * d * f
    assert real.bytes == fake.bytes > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(4096, 6400), (6400, 4096)])
def test_cuda_group_matmul_serving_decode_shape(cuda_device, d, f):
    """The serving path's decode-step expert products (Phi-3.5-MoE: 16
    experts, capacity 1 padded to one 8-row tile, bf16) against the plain
    version."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xe = torch.randn((16, 1, d), generator=gen, device=cuda_device
                     ).to(torch.bfloat16)
    w = (torch.randn((16, d, f), generator=gen, device=cuda_device)
         * 0.25).to(torch.bfloat16)
    got = grouped_expert_matmul(xe, w)
    eid = torch.arange(16, dtype=torch.int32, device=cuda_device)
    xp = torch.nn.functional.pad(xe, (0, 0, 0, 7)).reshape(128, d)
    want = group_matmul_plain(xp, eid, w, tile_m=8).reshape(16, 8, f)[:, :1]
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_group_matmul_errors(cuda_device):
    """A refused launch raises (a grid too tall for the card), and an
    expert id out of range gives NaN rows rather than a read outside w."""
    # 70,000 tiles: more than the 65,535 CTAs a grid's y axis takes
    x = torch.ones((8 * 70000, 1), device=cuda_device)
    w = torch.ones((1, 1, 8), device=cuda_device)
    eid = torch.zeros((70000,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        group_matmul(x, eid, w, tile_m=8)
    x = torch.ones((16, 4), device=cuda_device)
    w = torch.ones((2, 4, 8), device=cuda_device)
    eid = torch.tensor([1, 5], dtype=torch.int32, device=cuda_device)
    got = group_matmul(x, eid, w, tile_m=8).cpu()
    assert torch.all(got[:8] == 4) and torch.isnan(got[8:]).all()


# Each case reaches one launch variant of csrc/group_matmul.cu by name: the
# weight stream for tile_m <= 8 ("stream8") and <= 16 ("stream16") with the
# wide (16- or 8-byte) weight loads when f allows them ("vec") or scalar
# loads ("scalar"); for wider bf16 tiles whose d and f are multiples of 8
# the tensor-core shape, 64-row ("tc64", tile_m <= 64) or 128-row ("tc128")
# blocks of one tile; for the other wide tiles (f32, or bf16 that the TMA
# cannot take) the 128 x 128 tiled shape.  A last field True runs the case
# with w transposed (trans_w, (e, f, d), read in place on the tensor-core
# shape; "+copy": the operator's contiguous transposed copy elsewhere).
# The expert ids are a pattern: "runs" puts equal ids on neighbouring tiles
# (one run per CTA where a CTA spans several tiles), "mixed" a new id on
# every tile, "bad" an out-of-range id in the middle of a run.
GM_VARIANTS = [
    # variant, dtype, tiles, tile_m, d, f, experts, ids, trans_w
    ("stream8_vec", torch.bfloat16, 5, 1, 64, 256, 3, "mixed", False),
    ("stream8_vec", torch.bfloat16, 4, 8, 4100, 512, 4, "mixed", False),
    ("stream8_vec", torch.float32, 3, 4, 1500, 132, 2, "mixed", False),
    ("stream8_scalar", torch.bfloat16, 4, 8, 4100, 130, 4, "mixed", False),
    ("stream8_scalar", torch.float32, 6, 8, 300, 9, 3, "bad", False),
    ("stream16_vec", torch.bfloat16, 3, 16, 4500, 260, 3, "mixed", False),
    ("stream16_vec", torch.float32, 2, 12, 2100, 64, 2, "bad", False),
    ("stream16_scalar", torch.bfloat16, 3, 16, 1000, 65, 2, "mixed", False),
    ("tiled_vec", torch.float32, 12, 24, 200, 256, 3, "runs", False),
    ("tiled_vec", torch.float32, 16, 32, 136, 260, 3, "mixed", False),
    ("tiled_vec", torch.float32, 6, 64, 96, 128, 2, "bad", False),
    ("tiled_vec", torch.float32, 3, 128, 1024, 200, 2, "mixed", False),
    ("tiled_scalar", torch.float32, 8, 32, 33, 65, 3, "runs", False),
    ("tiled_scalar", torch.bfloat16, 5, 24, 130, 72, 2, "bad", False),
    ("tiled_vec", torch.bfloat16, 4, 60, 256, 132, 3, "mixed", False),
    ("tiled_vec+copy", torch.float32, 4, 32, 96, 200, 3, "mixed", True),
    ("tiled_vec+copy", torch.bfloat16, 4, 60, 256, 132, 3, "runs", True),
] + [
    (v, torch.bfloat16, *case, tw)
    for v, *case in [
        ("tc64", 8, 17, 200, 136, 3, "mixed"),
        ("tc64", 8, 32, 512, 384, 4, "runs"),
        ("tc64", 6, 60, 2048, 1408, 4, "mixed"),
        ("tc64", 5, 60, 136, 200, 2, "bad"),
        ("tc64", 4, 64, 200, 264, 3, "mixed"),
        ("tc128", 6, 128, 1024, 520, 3, "runs"),
        ("tc128", 4, 128, 200, 136, 2, "bad"),
        ("tc128", 3, 130, 264, 200, 2, "mixed"),
    ]
    for tw in (False, True)]


def _expert_ids(pattern, tiles, e, rng):
    if pattern == "runs":
        return (np.arange(tiles) // 4 % e).astype(np.int32)
    ids = rng.integers(0, e, tiles).astype(np.int32)
    if pattern == "mixed":
        ids[1::2] = (ids[::2][:len(ids[1::2])] + 1) % e
    else:   # "bad": out of range inside a run of equal ids
        ids[:] = 0
        ids[tiles // 2] = e + 3
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize(
    "variant,dtype,tiles,tile_m,d,f,e,ids,trans_w", GM_VARIANTS,
    ids=[f"{v[0]}-{str(v[1])[6:]}-t{v[3]}-d{v[4]}-f{v[5]}-{v[7]}"
         + ("-wt" if v[8] else "") for v in GM_VARIANTS])
def test_cuda_group_matmul_launch_variants(cuda_device, variant, dtype, tiles,
                                           tile_m, d, f, e, ids, trans_w):
    """Every launch variant of the grouped-matmul kernel against the plain
    version: tile_m 1 to 130, aligned and unaligned f, d past the stream
    shape's shared-memory slab of x (4096 bf16 / 1024 f32 rows at 8 rows,
    2048 / 1024 at 16), d and f multiples of 8 but not of the tensor-core
    shape's 64-deep slice or 256-column block, tiles of one CTA with equal
    and with different expert ids, NaN rows for an out-of-range id, and w
    in both layouts; one launch a call."""
    from repro_torch.kernels.group_matmul import launch_shape
    shape, _, load = variant.removesuffix("+copy").partition("_")
    # the case reaches its variant: the launcher's choice, by shape (d
    # the contraction, f the output width in either layout)
    tensor_cores = dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0
    assert (tile_m <= 8 if shape == "stream8" else
            8 < tile_m <= 16 if shape == "stream16" else
            16 < tile_m <= 64 and tensor_cores if shape == "tc64" else
            tile_m > 64 and tensor_cores if shape == "tc128" else
            tile_m > 16 and not tensor_cores)
    if shape == "tiled":
        assert (d % 4 == 0 and f % 4 == 0) == (load == "vec")
    elif shape.startswith("stream"):   # 16 bytes a lane, or 8 (bf16, R 16)
        wide = f % (8 if (shape, dtype) == ("stream8", torch.bfloat16)
                    else 4) == 0
        assert wide == (load == "vec")
    assert variant.endswith("+copy") == (trans_w and
                                         not shape.startswith("tc"))
    rng = np.random.default_rng(tiles * 1000 + tile_m + d + f)
    x = torch.as_tensor(rng.standard_normal((tiles * tile_m, d)),
                        dtype=dtype, device=cuda_device)
    # unit-variance outputs at every depth
    w = torch.as_tensor(rng.standard_normal((e, f, d) if trans_w else
                                            (e, d, f)) / np.sqrt(d),
                        dtype=dtype, device=cuda_device)
    eid = torch.as_tensor(_expert_ids(ids, tiles, e, rng), device=cuda_device)
    # ... and the C launcher takes it
    assert launch_shape(x, w, tile_m=tile_m, trans_w=trans_w) == variant
    before = group_matmul.launches
    got = group_matmul(x, eid, w, tile_m=tile_m, trans_w=trans_w)
    torch.cuda.synchronize()
    assert group_matmul.launches == before + 1
    assert got.shape == (tiles * tile_m, f)
    want = group_matmul_plain(x, eid, w, tile_m=tile_m, trans_w=trans_w)
    bad = ((eid < 0) | (eid >= e)).repeat_interleave(tile_m)
    assert torch.isnan(got[bad]).all() and not torch.isnan(got[~bad]).any()
    # f32: 1e-5 up to d = 128 as the reference kernel tests, 1e-4 past it
    # as the reference benchmark; bf16 products are exact in f32, so only
    # the summation order differs, and 2e-2 is the reference's bf16 limit
    tol = (1e-5 if d <= 128 else 1e-4) if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", bench_kernels.TC_EXACT_CASES,
                         ids=[f"t{c[1]}-d{c[2]}-f{c[3]}"
                              for c in bench_kernels.TC_EXACT_CASES])
def test_cuda_group_matmul_tensor_cores_exact(cuda_device, case):
    """The tensor-core shape on integer-valued bf16 operands (|x|, |w| <=
    8, d <= 1024: every sum exact in f32, in any order) equals the plain
    version bit for bit with w as stored and transposed: a wrong fragment,
    descriptor, swizzle or transpose moves some output by a whole unit."""
    shapes = bench_kernels.tc_exact(cuda_device, cases=(case,))
    assert len(shapes) == 2 and all(v in ("tc64", "tc128")
                                    for v in shapes.values())


@pytest.mark.cuda
@pytest.mark.parametrize("tile_m", [60, 128])
def test_cuda_group_matmul_tensor_cores_repeat_bit_equal(cuda_device,
                                                         tile_m):
    """Two calls of the tensor-core shape on the same operands give the
    same bits, in both layouts: its sums run in an order fixed by the
    shapes (no atomics, no split of the contraction)."""
    rng = np.random.default_rng(tile_m)
    tiles, d, f, e = 6, 1024, 776, 3
    x = torch.as_tensor(rng.standard_normal((tiles * tile_m, d)),
                        dtype=torch.bfloat16, device=cuda_device)
    eid = torch.as_tensor(rng.integers(0, e, tiles), dtype=torch.int32,
                          device=cuda_device)
    for shape in ((e, d, f), (e, f, d)):
        w = torch.as_tensor(rng.standard_normal(shape) / np.sqrt(d),
                            dtype=torch.bfloat16, device=cuda_device)
        tw = shape[1] == f
        first = group_matmul(x, eid, w, tile_m=tile_m, trans_w=tw)
        assert torch.equal(first, group_matmul(x, eid, w, tile_m=tile_m,
                                               trans_w=tw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,n,bm,bn,dk,nblk,live", [
    (256, 512, 512, 128, 128, 128, 9, 6),     # the leg's blocks, lanes past 6
    (64, 100, 96, 16, 16, 128, 11, None),     # d padded to dk
    (32, 203, 48, 8, 8, 1, 7, 3),             # d % 4 != 0: scalar loads
    (256, 72, 36, 128, 6, 8, 5, None),        # bn % 4 != 0: scalar loads
    (384, 64, 256, 128, 128, 64, 4, 0),       # no live lane: all zero
])
def test_cuda_sddmm_tiles(cuda_device, dtype, m, d, n, bm, bn, dk, nblk,
                          live):
    """The sddmm kernel on the f32 tile core against the plain version:
    128 x 64 CTA tiles over blocks of 8, 16, 128 (and 6 columns), d that
    is not a multiple of dk or of 4, and lanes at or past n_blocks zero."""
    rng = np.random.default_rng(m + d + n + bm)
    a = torch.as_tensor(rng.standard_normal((m, d)), dtype=dtype,
                        device=cuda_device)
    # unit-variance outputs at every depth
    b = torch.as_tensor(rng.standard_normal((d, n)) / np.sqrt(d), dtype=dtype,
                        device=cuda_device)
    brow = torch.as_tensor(rng.integers(0, m // bm, nblk), dtype=torch.int32,
                           device=cuda_device)
    bcol = torch.as_tensor(rng.integers(0, n // bn, nblk), dtype=torch.int32,
                           device=cuda_device)
    before = sddmm_blocks.launches
    got = sddmm_blocks(brow, bcol, a, b, bm=bm, bn=bn, dk=dk, n_blocks=live)
    torch.cuda.synchronize()
    assert sddmm_blocks.launches == before + 1
    want = sddmm_blocks_plain(brow, bcol, a, b, bm=bm, bn=bn, n_blocks=live)
    tol = (1e-5 if d <= 128 else 1e-4) if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if live is not None:
        assert torch.all(got[live:] == 0)


# Each case of the bcsr_spmm kernel: block shape, live blocks in each
# block-row (block-columns drawn at random), block-columns, k, bk, and how
# many padding lanes past n_blocks the capacity adds (poisoned: 1e6 blocks
# naming block-column 1).
BCSR_CASES = [
    # name, (bm, bn), blocks a row, nb, k, bk, padding lanes
    ("leg_blocks", (128, 128), [2, 2, 0, 2], 8, 512, 128, 0),
    ("row_of_7", (64, 48), [7, 3], 8, 256, 128, 0),   # ranges cross blocks
    ("bn8", (8, 8), [3, 0, 5, 8, 1, 2, 0, 4], 8, 64, 64, 0),
    ("bn16", (16, 16), [4, 1, 0, 6], 8, 128, 128, 0),
    ("bn6_scalar", (16, 6), [3, 5, 0, 2], 10, 64, 64, 0),
    ("k100_padded", (32, 32), [2, 4, 1, 3], 4, 100, 128, 0),
    ("cap_past_live", (16, 16), [2, 0, 3, 1], 4, 64, 64, 5),
    ("no_live_block", (128, 64), [0, 0], 2, 128, 128, 0),
]


def _bcsr_operands(rng, bm, bn, per_row, nb, k, pad, dtype, device):
    """A block-CSR A with the given live blocks per block-row, its dense
    B (unit-variance outputs at every depth), and the rows with no live
    block."""
    mb = len(per_row)
    a_dense = np.zeros((mb * bm, nb * bn), np.float32)
    for r, n in enumerate(per_row):
        for c in rng.choice(nb, n, replace=False):
            a_dense[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn] = \
                rng.standard_normal((bm, bn))
    n_live = sum(per_row)
    a = BCSR.from_dense(a_dense, block=(bm, bn), cap=max(1, n_live + pad),
                        dtype=dtype, device=device)
    if pad:
        blocks, indices = a.blocks.clone(), a.indices.clone()
        blocks[n_live:] = 1e6
        indices[n_live:] = 1
        a = BCSR(a.indptr, indices, blocks, a.n_blocks, a.shape, a.block)
    depth = max(1, max(per_row) * bn)
    b = torch.as_tensor(rng.standard_normal((nb * bn, k)) / np.sqrt(depth),
                        dtype=dtype, device=device)
    empty = np.repeat(np.asarray(per_row) == 0, bm)
    return a, b, empty, depth


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,block,per_row,nb,k,bk,pad", BCSR_CASES,
                         ids=[c[0] for c in BCSR_CASES])
def test_cuda_bcsr_spmm_tiles(cuda_device, name, block, per_row, nb, k, bk,
                              pad, dtype, split):
    """The bcsr_spmm kernel (128 x 64 tiles of the f32 tile core, each
    block-row's contraction split over a cluster of ``split`` ranks)
    against the plain version: the leg's 128 x 128 blocks, a row of 7
    blocks whose split ranges cross block boundaries, bn of 8, 16 and 6
    (scalar loads), k padded to bk, padding lanes past n_blocks that must
    not count, and an A without a live block; empty rows exactly zero."""
    rng = np.random.default_rng(sum(per_row) * 100 + nb + k)
    a, b, empty, depth = _bcsr_operands(rng, *block, per_row, nb, k, pad,
                                        dtype, cuda_device)
    before = bcsr_spmm.launches
    got = bcsr_spmm(a, b, bk=bk, split=split)
    torch.cuda.synchronize()
    assert bcsr_spmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (a.shape[0], k)
    want = bcsr_spmm_plain(a, b)
    # f32: 1e-5 up to a depth of 128 as the reference kernel tests, 1e-4
    # past it as the reference benchmark; bf16: the reference's 2e-2
    tol = (1e-5 if depth <= 128 else 1e-4) if dtype == torch.float32 \
        else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.all(got[torch.as_tensor(empty, device=cuda_device)] == 0)


@pytest.mark.cuda
def test_cuda_kernels_repeat_bit_equal(cuda_device):
    """Two calls on the same inputs give the same bits: no kernel sums
    with atomics, and the cluster reduction of bcsr_spmm adds its ranks'
    partials in a fixed order at every split."""
    legs = bench_kernels.leg_inputs(torch.float32, "cuda")
    for name, args in legs.items():
        first = bench_kernels.run_kernel(name, args)
        assert torch.equal(first, bench_kernels.run_kernel(name, args)), name
    a, b = legs["bcsr_spmm"]["a"], legs["bcsr_spmm"]["b"]
    for split in (1, 2, 4, 8):
        first = bcsr_spmm(a, b, split=split)
        assert torch.equal(first, bcsr_spmm(a, b, split=split)), split


@pytest.mark.cuda
def test_cuda_f32_kernels_do_not_round_to_tf32(cuda_device):
    """f32 inputs whose products and sums are exact in f32 but not in TF32
    (x = 1 + j 2^-13: TF32 keeps 10 mantissa bits and rounds x to 1), held
    to the float64 result within 1e-4: both group_matmul shapes, sddmm and
    bcsr_spmm at every split.  A TF32 product would be off by about 0.1
    here."""
    rng = np.random.default_rng(7)
    d = 256

    def exact_x(rows):
        return 1 + rng.integers(1, 8, (rows, d)) * 2.0 ** -13

    w64 = rng.integers(1, 4, (2, d, 64)).astype(np.float64)
    w = torch.as_tensor(w64, dtype=torch.float32, device=cuda_device)
    for tile_m in (8, 32):
        x64 = exact_x(4 * tile_m)
        eid = np.array([0, 1, 1, 0], dtype=np.int32)
        want = np.concatenate([x64[i * tile_m:(i + 1) * tile_m] @ w64[e]
                               for i, e in enumerate(eid)])
        got = group_matmul(torch.as_tensor(x64, dtype=torch.float32,
                                           device=cuda_device),
                           torch.as_tensor(eid, device=cuda_device), w,
                           tile_m=tile_m)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                   atol=1e-4)
    a64 = exact_x(256)
    b64 = rng.integers(1, 4, (d, 128)).astype(np.float64)
    brow = np.array([1, 0], dtype=np.int32)
    bcol = np.array([0, 1], dtype=np.int32)
    got = sddmm_blocks(torch.as_tensor(brow, device=cuda_device),
                       torch.as_tensor(bcol, device=cuda_device),
                       torch.as_tensor(a64, dtype=torch.float32,
                                       device=cuda_device),
                       torch.as_tensor(b64, dtype=torch.float32,
                                       device=cuda_device), bm=128, bn=64)
    want = np.stack([a64[r * 128:(r + 1) * 128] @ b64[:, c * 64:(c + 1) * 64]
                     for r, c in zip(brow, bcol)])
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=1e-4)
    # two 128 x 128 blocks of A's first block-row and one of its second:
    # depths of 256 and 128, split across block boundaries
    a64 = np.zeros((256, 384))
    for r, c in ((0, 0), (0, 2), (1, 1)):
        a64[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = exact_x(128)[
            :, :128]
    b64 = rng.integers(1, 4, (384, 64)).astype(np.float64)
    a = BCSR.from_dense(a64.astype(np.float32), block=(128, 128),
                        device=cuda_device)
    b = torch.as_tensor(b64, dtype=torch.float32, device=cuda_device)
    for split in (1, 2, 4, 8):
        got = bcsr_spmm(a, b, split=split)
        np.testing.assert_allclose(got.cpu().numpy(), a64 @ b64, rtol=0,
                                   atol=1e-4)


@pytest.mark.cuda
def test_cuda_fast_forward_matches_plain(cuda_device):
    """The simulator on the card: the 64-node pointer chase at 8x8
    (chunk 64) gives the same bits on the fast-forward and the plain
    engine and on the CPU, and the fast-forward skips PE-steps."""
    import dataclasses

    from repro_torch.bench.workloads import pointer_chase_graph
    from repro_torch.core import compiler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.sweep import SweepRequest, sweep
    cfg = MachineConfig(width=8, height=8, mem_words=2048,
                        max_cycles=100_000)
    rowptr, col, src = pointer_chase_graph(64)
    req = SweepRequest(workloads=[compiler.build_bfs(rowptr, col, src, cfg)],
                       chunk=64)
    ff = sweep(cfg, req, device=cuda_device)
    plain = sweep(dataclasses.replace(cfg, fast_forward=False), req,
                  device=cuda_device)
    cpu = sweep(cfg, req, device="cpu")

    def sig(r):
        return (r.to_json(), np.asarray(r.stall_per_port).tolist(),
                np.asarray(r.mem_val).tolist())

    assert sig(ff[0]) == sig(plain[0]) == sig(cpu[0])
    assert ff[0].completed
    assert ff.telemetry == cpu.telemetry
    assert ff.telemetry.dead_step_fraction > 0.2
    assert plain.telemetry.dead_step_fraction == 0.0


@pytest.mark.cuda
def test_cuda_packed_deadline_sweep_matches_golden(cuda_device):
    """The packed deadline leg of ``sweeps.json`` on the card: every lane,
    the packing schedule and the telemetry equal the reference's."""
    from repro_torch.bench import golden
    from repro_torch.core.sweep import SweepRequest, sweep
    cfg, kw, keys = golden.port_sweep_leg("deadline")
    report = sweep(cfg, SweepRequest(**kw), device=cuda_device)
    golden.check_sweep(golden.sweep_record("deadline", keys, report),
                       golden.load_sweep_golden()["deadline"])


@pytest.mark.cuda
def test_cuda_service_soak_matches_golden(cuda_device):
    """The sweep service on the card: the chaos soak of the
    ``fig17_traffic(copies=2)`` lanes (seeded transients and a kill, a
    deadline lane, duplicates, checkpoints, a restore from the middle
    checkpoint) equals ``service.json`` bit for bit."""
    from repro_torch.bench import chaos_soak, golden
    rec = chaos_soak.run(5, golden=golden.load_service_golden(),
                         device=cuda_device, verbose=False)
    assert rec["failures"] == []
    assert {k for _, _, k in rec["fired"]} == {"transient", "kill"}
    assert rec["restored_lanes"] > 0


def _plain_grouped(xe, w, tile_m):
    """The plain version of ``grouped_expert_matmul`` at ``tile_m``."""
    from repro_torch.kernels.group_matmul import tile_by_expert
    e, c, _ = xe.shape
    x, eid, tile_m = tile_by_expert(xe, tile_m)
    out = group_matmul_plain(x, eid, w, tile_m=tile_m)
    return out.reshape(e, -1, w.shape[2])[:, :c]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_m,c,d,f", [
    (8, 1, 96, 200), (8, 5, 96, 200), (8, 17, 33, 65), (16, 16, 96, 200),
    (16, 33, 130, 70), (128, 128, 96, 200), (128, 160, 130, 70),
    (128, 300, 96, 200)])
def test_cuda_grouped_expert_matmul_grads_match_plain(cuda_device, dtype,
                                                      tile_m, c, d, f):
    """The differentiable expert product on the card: the forward and the
    backward's dx each launch the kernel once (the weight stream at
    tile_m 8 and 16, the tiled shape at 128; capacities below, at and
    past a tile) and agree with the plain version, and dw (``torch.bmm``)
    with an f64 product."""
    e = 3
    rng = np.random.default_rng(tile_m + c + d)

    def tol(depth):   # as test_cuda_group_matmul_matches_plain
        if dtype == torch.bfloat16:
            return dict(rtol=2e-2, atol=2e-2)
        return dict(rtol=1e-5, atol=1e-5) if depth <= 128 else \
            dict(rtol=1e-4, atol=1e-4)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=cuda_device)
    xe, w, cot = t(e, c, d).requires_grad_(), t(e, d, f).requires_grad_(), \
        t(e, c, f)
    before = group_matmul.launches
    y = grouped_expert_matmul(xe, w, tile_m=tile_m)
    (y * cot.float()).sum().backward()
    torch.cuda.synchronize()
    assert group_matmul.launches == before + 2
    assert xe.grad.dtype == w.grad.dtype == dtype
    with torch.no_grad():
        torch.testing.assert_close(y, _plain_grouped(xe, w, tile_m),
                                   **tol(d))
        want_dx = _plain_grouped(cot, w.transpose(1, 2).contiguous(), tile_m)
        torch.testing.assert_close(xe.grad.float(), want_dx, **tol(f))
        want_dw = torch.einsum("ecd,ecf->edf", xe.double().cpu(),
                               cot.double().cpu())
        np.testing.assert_allclose(w.grad.double().cpu().numpy(),
                                   want_dw.numpy(), **tol(c))


@pytest.mark.cuda
def test_cuda_train_step_matches_golden(cuda_device):
    """The reduced Phi-3.5-MoE in f32: one step of ``train()`` on the card
    meets the reference's first step in ``train_reduced.json``."""
    from repro_torch import configs
    from repro_torch.bench import golden
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.train import train
    spec = dict(golden.TRAIN_SPEC, steps=1)
    cfg = configs.get_arch(spec["arch"]).reduced()
    params = params_from_numpy(
        golden.serve_params_numpy(cfg, spec["param_seed"]), cfg, cuda_device)
    before = group_matmul.launches
    res = train(spec["arch"], steps=1, batch=spec["batch"], seq=spec["seq"],
                lr=spec["lr"], device=cuda_device, params=params,
                log_every=0)
    assert group_matmul.launches - before == 6 * cfg.n_layers
    want = golden.load_train_golden()
    golden.check_train(res.losses, res.aux_losses, res.grad_norms,
                       {k: want[k][:1] for k in ("loss", "aux_loss",
                                                 "grad_norm")})


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(2048, 1408), (1408, 2048)])
def test_cuda_grouped_expert_matmul_deepseek_training_shape(cuda_device, d,
                                                            f):
    """DeepSeek-V2-Lite's training products (64 experts; 4 x 128 tokens,
    top-6, capacity factor 1.25: capacity 60, so tile_m 60, a tile that is
    no multiple of 8, on the tiled shape) and their dx against the plain
    version, as ``chip_smoke.py``'s ``[train-families]`` leg holds them
    (rtol = atol = 2e-2, max |err| within 2e-2 of max |plain|)."""
    e, c = 64, 60
    rng = np.random.default_rng(d)

    def t(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.bfloat16, device=cuda_device)
    xe, w = t(e, c, d).requires_grad_(), t(e, d, f, scale=d ** -0.5)
    w.requires_grad_()
    cot = t(e, c, f)
    before = group_matmul.launches
    y = grouped_expert_matmul(xe, w)
    (y * cot.float()).sum().backward()
    torch.cuda.synchronize()
    assert group_matmul.launches == before + 2
    with torch.no_grad():
        for got, want in (
                (y, _plain_grouped(xe, w, None)),
                (xe.grad.float(),
                 _plain_grouped(cot, w.transpose(1, 2).contiguous(), None))):
            torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
            err = (got - want).abs().max().item()
            assert err <= 2e-2 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_cuda_train_families_meet_golden(cuda_device, arch):
    """The reduced families in f32 on the card meet
    ``train_families_reduced.json``; DeepSeek's expert products and their
    dx launch the kernel (3 a layer a step each), the others none."""
    from repro_torch import configs
    from repro_torch.bench import golden
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_arch(configs.ALIASES[arch]).reduced()
    before = group_matmul.launches
    got = golden.train_family_run(arch, cuda_device)
    steps = golden.TRAIN_FAMILIES_SPEC["steps"]
    assert group_matmul.launches - before == (
        2 * 3 * cfg.n_layers * steps if cfg.moe is not None else 0)
    golden.check_train(got["loss"], got["aux_loss"], got["grad_norm"],
                       golden.load_train_families_golden()["archs"][arch])


@pytest.mark.cuda
def test_cuda_static_engine_matches_golden(cuda_device):
    """The static golden engine on the card: grid A's spmv, bfs and sddmm
    nexus lanes at 4x4 with the mode and the mesh baked in equal
    ``paper_grid.json`` bit for bit, and their final state is idle."""
    import dataclasses

    from repro_torch.bench import golden, harness
    from repro_torch.bench.workloads import make_all
    from repro_torch.bench.multidevice import EngineCalls
    from repro_torch.core import machine
    spec = dict(golden.GRIDS["grid_a"], workloads=["spmv", "bfs", "sddmm"])
    wls = golden.grid_workloads(spec, make_all())
    cap = EngineCalls()
    machine._get_engine = cap
    try:
        lanes, _ = harness.run_grid_lanes(
            wls, ["nexus"], base_cfg=machine.MachineConfig(
                traced_modes=False, traced_geometry=False),
            max_cycles=golden.MAX_CYCLES, device=cuda_device)
    finally:
        machine._get_engine = cap.inner
    # the golden run's memory images are as wide as grid A's widest lane
    # (4,096 words); these lanes' images are padded with the zeros that
    # their unused words hold there
    got = {}
    for ln in lanes:
        mem = ln.result.mem_val
        res = dataclasses.replace(ln.result, mem_val=np.pad(
            mem, ((0, 0), (0, 4096 - mem.shape[1]))))
        got[golden.lane_key(ln.workload.name, ln.mode, ln.size)] = \
            golden.lane_record(res)
    want = golden.load_golden()["grid_a"]["lanes"]
    golden.check_lanes(got, {k: want[k] for k in got})
    assert cap.outs and bool(machine.is_idle(cap.outs[-1][0]))


@pytest.mark.cuda
def test_cuda_sharded_grid_matches_golden(cuda_device):
    """The 18-lane grid of ``shard.json`` over four logical shards of the
    card, bit for bit against the reference's four-device record (lanes,
    plan, per-shard telemetry) on one cached engine."""
    from repro_torch.bench import golden
    from repro_torch.core import machine
    from repro_torch.core.sweep import SweepRequest, sweep
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(golden.SHARD_DEVICES, 1,
                          devices=[dev] * golden.SHARD_DEVICES)
    cfg, kw, keys = golden.port_shard_leg("grid")
    machine.clear_engine_cache()
    report = sweep(cfg, SweepRequest(**kw), device=dev,
                   devices=mesh.devices_along("data"))
    golden.check_shard(golden.shard_record("grid", keys, report),
                       golden.load_shard_golden()["grid"])
    assert machine.engine_cache_size() == 1


@pytest.mark.cuda
def test_cuda_spmv_sharded_eight_logical_shards(cuda_device):
    """``spmv_sharded`` over 8 logical shards of the card: the example's
    power-law matrix within 1e-3 of ``a @ x``, plain and with stealing at
    the worst bucket's capacity (a no-op)."""
    from repro_torch.launch import sparse_dispatch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sparse import dispatch
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(8, 1, devices=[dev] * 8)
    rng = np.random.default_rng(3)
    a = sparse_dispatch.powerlaw_sparse(1024, 1024, rng)
    x = rng.standard_normal(1024).astype(np.float32)
    sh = dispatch.shard_csr_rows(a, 8)
    worst = max(int(np.bincount(sh["col"][s, :sh["nnz"][s]] // 128,
                                minlength=8).max()) for s in range(8))
    want = a.astype(np.float64) @ x
    for kw in ({}, dict(capacity=worst, opportunistic=True)):
        y = dispatch.spmv_sharded(mesh, sh, x, **kw)
        assert np.abs(y - want).max() < 1e-3
