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
    x = torch.ones((8, 1), device=cuda_device)
    w = torch.ones((1, 1, 64 * 70000), device=cuda_device)
    eid = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        group_matmul(x, eid, w, tile_m=8)
    x = torch.ones((16, 4), device=cuda_device)
    w = torch.ones((2, 4, 8), device=cuda_device)
    eid = torch.tensor([1, 5], dtype=torch.int32, device=cuda_device)
    got = group_matmul(x, eid, w, tile_m=8).cpu()
    assert torch.all(got[:8] == 4) and torch.isnan(got[8:]).all()
