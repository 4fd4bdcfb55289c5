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
                                 sddmm_blocks, sddmm_blocks_plain)
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
