"""The port's scale-layer oracles against the reference's on the CPU:
``CSR`` (round trips, ``row_ids`` with padding and empty rows),
``random_csr`` and the six float ops of ``sparse/ops.py`` on the same
numpy inputs (f32, rtol = atol = 1e-5: only the summation order differs),
plus the port's copy of the hypothesis shim.  ``jax.random``'s stream
cannot be reproduced in torch, so every comparison goes through
``CSR.from_dense`` of one numpy matrix."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.testing as ref_testing  # noqa: E402
from repro.sparse import formats as ref_formats  # noqa: E402
from repro.sparse import ops as ref_ops  # noqa: E402

import repro_torch.testing as testing  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.sparse import ops  # noqa: E402
from repro_torch.sparse.formats import BCSR, CSR, random_csr  # noqa: E402

TOL = 1e-5


def _sparse(rng, m, n, density, empty_rows=()):
    a = np.where(rng.random((m, n)) < density, rng.standard_normal((m, n)),
                 0).astype(np.float32)
    a[list(empty_rows)] = 0
    return a


def _both(a, cap=None):
    return (CSR.from_dense(a, cap=cap, device="cpu"),
            ref_formats.CSR.from_dense(a, cap=cap))


@pytest.mark.parametrize("cap", [None, 90])
def test_csr_round_trip_and_row_ids_match_reference(cap):
    """from_dense -> to_dense gives the matrix back; rowptr, col, val, nnz
    and ``row_ids`` (padding lanes mapped to row 0, empty rows skipped)
    equal the reference's."""
    a = _sparse(np.random.default_rng(0), 12, 9, 0.4, empty_rows=(0, 5, 11))
    got, want = _both(a, cap)
    assert got.nnz == int(want.nnz) and got.shape == want.shape
    for k in ("rowptr", "col", "val"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    np.testing.assert_array_equal(got.row_ids.numpy(),
                                  np.asarray(want.row_ids))
    np.testing.assert_array_equal(got.to_dense().numpy(), a)
    np.testing.assert_array_equal(np.asarray(want.to_dense()), a)
    if cap:
        assert got.col.shape == (cap,)
        with pytest.raises(ValueError, match="cap"):
            CSR.from_dense(a, cap=got.nnz - 1, device="cpu")


def test_random_csr_draws_from_its_generator():
    """A seeded generator gives the same matrix twice, on its device, at
    about the density asked, in the dtype asked; the capacity pads."""
    got = [random_csr(torch.Generator().manual_seed(3), 64, 48, 0.1,
                      cap=400) for _ in range(2)]
    a, b = got
    assert a.shape == (64, 48) and a.val.dtype == torch.float32
    assert a.val.device.type == "cpu" and a.col.shape == (400,)
    assert torch.equal(a.to_dense(), b.to_dense()) and a.nnz == b.nnz
    assert 0.05 * 64 * 48 < a.nnz < 0.15 * 64 * 48
    np.testing.assert_array_equal(
        CSR.from_dense(a.to_dense().numpy(), device="cpu").row_ids.numpy(),
        a.row_ids[:a.nnz].numpy())
    half = random_csr(torch.Generator().manual_seed(3), 8, 8, 0.5,
                      dtype=torch.float64)
    assert half.val.dtype == torch.float64


def _ops_inputs():
    rng = np.random.default_rng(7)
    a = _sparse(rng, 24, 16, 0.3, empty_rows=(2, 9))
    b = _sparse(rng, 16, 20, 0.25)
    mask = _sparse(rng, 24, 20, 0.2)
    dense = {"x": rng.standard_normal(16).astype(np.float32),
             "bd": rng.standard_normal((16, 5)).astype(np.float32),
             "ad": rng.standard_normal((24, 6)).astype(np.float32),
             "bt": rng.standard_normal((6, 20)).astype(np.float32),
             "blocks": _sparse(rng, 32, 64, 0.3)}
    # block-sparse: zero two of the (8, 16) blocks and one block-row
    blk = dense["blocks"]
    blk[0:8, 16:32] = 0
    blk[8:16] = 0
    return a, b, mask, dense


def _op_args(name, pkg):
    """The op's arguments in one package (every op but ``spmadd``): CSRs
    with spare capacity, dense operands as tensors or arrays."""
    a, b, mask, d = _ops_inputs()
    if pkg == "port":
        csr = lambda x, cap: CSR.from_dense(x, cap=cap, device="cpu")  # noqa: E731
        arr = torch.as_tensor
        bcsr = BCSR.from_dense(d["blocks"], block=(8, 16), cap=20,
                               device="cpu")
    else:
        csr = lambda x, cap: ref_formats.CSR.from_dense(x, cap=cap)  # noqa: E731
        arr = jnp.asarray
        bcsr = ref_formats.BCSR.from_dense(d["blocks"], block=(8, 16),
                                           cap=20)
    ca, cb = csr(a, 160), csr(b, 100)
    return {"spmv": (ca, arr(d["x"])), "spmm": (ca, arr(d["bd"])),
            "spmspm_via_dense": (ca, cb),
            "sddmm": (arr(d["ad"]), arr(d["bt"]), csr(mask, 130)),
            "bcsr_spmm": (bcsr, arr(d["bd"].repeat(4, 0)[:64]))}[name]


@pytest.mark.parametrize("name", ops.__all__)
def test_op_matches_reference(name):
    """Each oracle equals ``repro.sparse.ops`` on the same inputs (f32,
    1e-5), padding lanes and empty rows included."""
    if name == "spmadd":      # two CSRs of one shape
        a = _ops_inputs()[0]
        other = np.where(a > 0, 0, np.roll(a, 3, axis=1)).astype(np.float32)
        got = ops.spmadd(CSR.from_dense(a, cap=160, device="cpu"),
                         CSR.from_dense(other, cap=150, device="cpu"))
        want = ref_ops.spmadd(ref_formats.CSR.from_dense(a, cap=160),
                              ref_formats.CSR.from_dense(other, cap=150))
        np.testing.assert_allclose(got.numpy(), a + other, rtol=TOL, atol=TOL)
    else:
        got = getattr(ops, name)(*_op_args(name, "port"))
        want = getattr(ref_ops, name)(*_op_args(name, "ref"))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_bcsr_oracle_equals_the_kernels_plain_version():
    """The block oracle and the kernel's plain version agree on a BCSR
    with spare capacity (the card holds the kernel to both)."""
    from repro_torch.kernels import bcsr_spmm_plain
    bcsr, b = _op_args("bcsr_spmm", "port")
    torch.testing.assert_close(ops.bcsr_spmm(bcsr, b),
                               bcsr_spmm_plain(bcsr, b), rtol=TOL, atol=TOL)


def test_sparse_package_exports():
    assert sparse.CSR is CSR and sparse.BCSR is BCSR
    assert sparse.random_csr is random_csr
    assert sorted(ops.__all__) == sorted(ref_ops.__all__)


def test_testing_shim_exports_the_reference_names():
    """The hypothesis shim: the reference's names, and the same
    availability."""
    for name in ("given", "settings", "strategies", "HAVE_HYPOTHESIS"):
        assert hasattr(testing, name), name
    assert testing.HAVE_HYPOTHESIS == ref_testing.HAVE_HYPOTHESIS
    if not testing.HAVE_HYPOTHESIS:
        deco = testing.given(testing.strategies.integers(0, 3))
        skipper = deco(lambda x: None)
        with pytest.raises(pytest.skip.Exception, match="hypothesis"):
            skipper()
