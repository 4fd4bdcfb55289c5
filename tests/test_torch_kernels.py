"""The port's block-sparse kernels: the plain PyTorch versions (what a CPU
tensor runs) against the JAX reference's Pallas kernels in interpret mode,
at the reference kernel tests' shapes, and the dispatch rules.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import bcsr_spmm as ref_bcsr_spmm  # noqa: E402
from repro.kernels import sddmm_blocks as ref_sddmm_blocks  # noqa: E402
from repro.sparse.formats import BCSR as RefBCSR  # noqa: E402

from repro_torch.convert import bcsr_from_numpy  # noqa: E402
from repro_torch.kernels import bcsr_spmm, sddmm_blocks  # noqa: E402
from repro_torch.kernels.bcsr_spmm import (MAX_SPLIT,  # noqa: E402
                                           split_ranks)
from repro_torch.sparse.formats import BCSR  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # f32: the reference kernel tests' 1e-5; bf16: their 2e-2 (both are
    # compared in f32 here, where only the summation order differs)
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _both_bcsr(a_dense, block, dtype_name, cap=None, poison=False):
    """The same BCSR operand for the reference and the port."""
    jdt, tdt = DTYPES[dtype_name]
    ra = RefBCSR.from_dense(a_dense, block=block, cap=cap)
    indices = np.asarray(ra.indices)
    blocks = np.asarray(ra.blocks)
    if poison:
        nb = int(ra.n_blocks)
        blocks = blocks.copy()
        blocks[nb:] = 1e6
        indices = indices.copy()
        indices[nb:] = 1
    ra = RefBCSR(ra.indptr, jnp.asarray(indices),
                 jnp.asarray(blocks).astype(jdt), ra.n_blocks, ra.shape,
                 ra.block)
    pa = bcsr_from_numpy(np.asarray(ra.indptr), indices, blocks,
                         int(ra.n_blocks), ra.shape, ra.block, device="cpu")
    pa = BCSR(pa.indptr, pa.indices, pa.blocks.to(tdt), pa.n_blocks,
              pa.shape, pa.block)
    return ra, pa


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("m,n,k,block,density", [
    (32, 64, 16, (8, 16), 0.3),
    (64, 64, 128, (16, 16), 0.15),
    (16, 128, 256, (8, 128), 0.5),
    (128, 256, 64, (8, 128), 0.05),
])
def test_bcsr_spmm_plain_matches_reference(m, n, k, block, density,
                                           dtype_name):
    """(d) the plain version equals the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(m * 1000 + n + k)
    a_dense = np.where(rng.random((m, n)) < density,
                       rng.standard_normal((m, n)), 0).astype(np.float32)
    b_np = rng.standard_normal((n, k)).astype(np.float32)
    ra, pa = _both_bcsr(a_dense, block, dtype_name)
    jdt, tdt = DTYPES[dtype_name]
    want = np.asarray(ref_bcsr_spmm(ra, jnp.asarray(b_np).astype(jdt),
                                    interpret=True), np.float32)
    before = bcsr_spmm.launches
    got = bcsr_spmm(pa, torch.as_tensor(b_np).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (m, k)
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype_name))
    assert bcsr_spmm.launches == before   # the CPU path launches nothing


@pytest.mark.parametrize("case", ["poisoned_padding", "empty_rows",
                                  "all_zero"])
def test_bcsr_spmm_plain_edge_cases(case):
    """(d) padding lanes never contribute, empty block-rows are exactly
    zero, an all-zero A gives zeros — as the reference kernel."""
    rng = np.random.default_rng(7)
    if case == "poisoned_padding":
        a_dense = np.where(rng.random((32, 32)) < 0.3,
                           rng.standard_normal((32, 32)), 0
                           ).astype(np.float32)
        ra, pa = _both_bcsr(a_dense, (8, 16), "float32", cap=64,
                            poison=True)
        b_np = rng.standard_normal((32, 16)).astype(np.float32)
    elif case == "empty_rows":
        a_dense = np.zeros((64, 32), np.float32)
        a_dense[8:16] = rng.standard_normal((8, 32))
        ra, pa = _both_bcsr(a_dense, (8, 16), "float32")
        b_np = rng.standard_normal((32, 16)).astype(np.float32)
    else:
        a_dense = np.zeros((16, 16), np.float32)
        ra, pa = _both_bcsr(a_dense, (8, 8), "float32")
        b_np = np.ones((16, 8), np.float32)
    want = np.asarray(ref_bcsr_spmm(ra, jnp.asarray(b_np), interpret=True))
    got = bcsr_spmm(pa, torch.as_tensor(b_np)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a_dense @ b_np, rtol=1e-5, atol=1e-5)
    if case == "empty_rows":
        assert np.all(got[:8] == 0) and np.all(got[16:] == 0)
    if case == "all_zero":
        assert np.all(got == 0)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", ["long_rows", "cap_past_live"])
def test_bcsr_spmm_plain_long_rows_and_capacity(case, dtype_name):
    """(d) the plain version equals the Pallas kernel (interpret mode) on
    rows of 7 blocks (the kernel splits such a row's contraction across
    block boundaries) and with a capacity past n_blocks whose padding
    lanes hold 1e6 blocks naming a live block-column."""
    rng = np.random.default_rng(11)
    bm, bn = 8, 16
    per_row = [7, 2, 0, 7] if case == "long_rows" else [1, 3, 0, 2]
    a_dense = np.zeros((len(per_row) * bm, 8 * bn), np.float32)
    for r, n in enumerate(per_row):
        for c in rng.choice(8, n, replace=False):
            a_dense[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn] = \
                rng.standard_normal((bm, bn))
    cap = sum(per_row) + (6 if case == "cap_past_live" else 0)
    ra, pa = _both_bcsr(a_dense, (bm, bn), dtype_name, cap=cap,
                        poison=case == "cap_past_live")
    assert pa.blocks.shape[0] == cap
    b_np = rng.standard_normal((8 * bn, 48)).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    want = np.asarray(ref_bcsr_spmm(ra, jnp.asarray(b_np).astype(jdt),
                                    interpret=True), np.float32)
    got = bcsr_spmm(pa, torch.as_tensor(b_np).to(tdt)).numpy()
    np.testing.assert_allclose(got, want, **_tol(dtype_name))
    assert np.all(got[2 * bm:3 * bm] == 0)


@pytest.mark.parametrize("mb,bm,kp,n_sms,fills", [
    (8, 128, 512, 132, False),      # the bcsr_spmm leg: 64 tiles
    (2, 128, 128, 132, False),      # 4 tiles
    (1, 8, 64, 132, False),         # one tile
    (40, 128, 512, 132, True),      # 320 tiles
    (128, 16, 128, 132, True),      # 256 tiles of 16-row blocks
    (33, 128, 256, 132, True),      # 132 tiles: one a SM
])
def test_bcsr_spmm_split_choice(mb, bm, kp, n_sms, fills):
    """The kernel's split S comes from shapes alone: the same every call,
    1 where the output tiles already fill the card, else the largest power
    of two within the portable cluster size of 8 that keeps the CTAs in
    one wave of two an SM (4 at the bcsr_spmm leg)."""
    split = split_ranks(mb, bm, kp, n_sms)
    assert split == split_ranks(mb, bm, kp, n_sms)
    assert 1 <= split <= MAX_SPLIT == 8 and split & (split - 1) == 0
    tiles = mb * -(-bm // 128) * -(-kp // 64)
    assert (tiles >= n_sms) == fills
    if (mb, bm, kp, n_sms) == (8, 128, 512, 132):
        assert split == 4
    if fills:
        assert split == 1
    else:
        assert split > 1 and tiles * split <= 2 * n_sms
        assert split == MAX_SPLIT or tiles * split * 2 > 2 * n_sms


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("m,d,n,bm,bn,dk,nblk", [
    (32, 64, 32, 8, 8, 16, 7),
    (64, 128, 64, 16, 16, 128, 12),
    (16, 256, 128, 8, 128, 64, 3),
])
def test_sddmm_plain_matches_reference(m, d, n, bm, bn, dk, nblk,
                                       dtype_name):
    """(d) the plain version equals the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(m + d + n)
    jdt, tdt = DTYPES[dtype_name]
    a_np = rng.standard_normal((m, d)).astype(np.float32)
    b_np = rng.standard_normal((d, n)).astype(np.float32)
    brow = rng.integers(0, m // bm, nblk).astype(np.int32)
    bcol = rng.integers(0, n // bn, nblk).astype(np.int32)
    want = np.asarray(ref_sddmm_blocks(
        jnp.asarray(brow), jnp.asarray(bcol), jnp.asarray(a_np).astype(jdt),
        jnp.asarray(b_np).astype(jdt), bm=bm, bn=bn, dk=dk, interpret=True),
        np.float32)
    before = sddmm_blocks.launches
    got = sddmm_blocks(torch.as_tensor(brow), torch.as_tensor(bcol),
                       torch.as_tensor(a_np).to(tdt),
                       torch.as_tensor(b_np).to(tdt), bm=bm, bn=bn, dk=dk)
    assert got.dtype == torch.float32 and got.shape == (nblk, bm, bn)
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype_name))
    assert sddmm_blocks.launches == before


def test_sddmm_plain_padding_and_unpadded_d():
    """(d) d not a multiple of dk, and lanes past n_blocks masked."""
    rng = np.random.default_rng(1)
    a_np = rng.standard_normal((16, 100)).astype(np.float32)
    b_np = rng.standard_normal((100, 16)).astype(np.float32)
    brow = np.array([0, 1, 1, 0], np.int32)
    bcol = np.array([0, 1, 0, 1], np.int32)
    want = np.asarray(ref_sddmm_blocks(
        jnp.asarray(brow), jnp.asarray(bcol), jnp.asarray(a_np),
        jnp.asarray(b_np), bm=8, bn=8, dk=128, n_blocks=2, interpret=True))
    got = sddmm_blocks(torch.as_tensor(brow), torch.as_tensor(bcol),
                       torch.as_tensor(a_np), torch.as_tensor(b_np), bm=8,
                       bn=8, dk=128, n_blocks=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[2:] == 0)


def test_wrappers_do_not_fall_back():
    """(g) a tensor that is not on the CPU never takes the plain version:
    a device without a kernel raises, and so does a CUDA request here."""
    a = BCSR.from_dense(np.eye(16, dtype=np.float32), block=(8, 8),
                        device="meta")
    with pytest.raises(ValueError, match="no bcsr_spmm"):
        bcsr_spmm(a, torch.empty((16, 8), device="meta"))
    idx = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no sddmm_blocks"):
        sddmm_blocks(idx, idx, torch.empty((16, 8), device="meta"),
                     torch.empty((8, 16), device="meta"), bm=8, bn=8)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            bcsr_spmm(BCSR.from_dense(np.eye(16, dtype=np.float32),
                                      block=(8, 8)),
                      torch.ones((16, 8), device="cuda"))


def test_wrappers_check_inputs():
    """Dtype, shape and contiguity are checked before any launch."""
    a = BCSR.from_dense(np.eye(16, dtype=np.float32), block=(8, 8),
                        device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        bcsr_spmm(a, torch.ones((16, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="b must be"):
        bcsr_spmm(a, torch.ones((8, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        bcsr_spmm(a, torch.ones((8, 16)).t())
    idx = torch.zeros((2,), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        sddmm_blocks(idx, idx, torch.ones((16, 8)), torch.ones((8, 16)),
                     bm=8, bn=8)
