"""The port's grouped matmul (MoE expert compute): the plain PyTorch
version (what a CPU tensor runs) against the reference's Pallas kernel in
interpret mode, at the reference kernel tests' shapes, and the wrapper's
checks.  The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import group_matmul as ref_group_matmul  # noqa: E402
from repro.kernels import \
    grouped_expert_matmul as ref_grouped_expert_matmul  # noqa: E402

from repro_torch.kernels import (group_matmul, group_matmul_plain,  # noqa: E402
                                 grouped_expert_matmul)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # the reference kernel tests' tolerances: f32 1e-5 (only the summation
    # order differs), bf16 2e-2 (both sides widen the same bf16 inputs)
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("tiles,tile_m,d,f,e", [
    (4, 8, 32, 64, 3),
    (8, 16, 128, 128, 4),
    (2, 8, 100, 72, 2),            # unaligned d/f
])
def test_group_matmul_matches_reference(tiles, tile_m, d, f, e, dtype_name):
    rng = np.random.default_rng(tiles * 100 + d + f)
    jdt, tdt = DTYPES[dtype_name]
    x = rng.standard_normal((tiles * tile_m, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    eid = rng.integers(0, e, tiles).astype(np.int32)
    want = np.asarray(ref_group_matmul(
        jnp.asarray(x).astype(jdt), jnp.asarray(eid),
        jnp.asarray(w).astype(jdt), tile_m=tile_m, interpret=True),
        np.float32)
    before = group_matmul.launches
    got = group_matmul(torch.as_tensor(x).to(tdt), torch.as_tensor(eid),
                       torch.as_tensor(w).to(tdt), tile_m=tile_m)
    assert got.dtype == torch.float32 and got.shape == (tiles * tile_m, f)
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype_name))
    assert group_matmul.launches == before   # the CPU path launches nothing


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("e,c,d,f,tile_m", [
    (4, 16, 32, 64, 8), (2, 10, 64, 32, 8),      # test_kernels.py
    (4, 24, 48, 96, 8),                           # the moe-einsum case
    (3, 6, 40, 24, None), (16, 1, 64, 48, None),  # serving-path capacities
    (2, 20, 16, 8, 16)])
def test_grouped_expert_matmul_matches_reference(e, c, d, f, tile_m,
                                                 dtype_name):
    """Capacity padding to ``tile_m`` (given, or the reference's default
    ``min(128, max(8, c))``) and the (e, c, f) cut back."""
    rng = np.random.default_rng(e * c + d + f)
    jdt, tdt = DTYPES[dtype_name]
    xe = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    want = np.asarray(ref_grouped_expert_matmul(
        jnp.asarray(xe).astype(jdt), jnp.asarray(w).astype(jdt),
        tile_m=tile_m, interpret=True), np.float32)
    got = grouped_expert_matmul(torch.as_tensor(xe).to(tdt),
                                torch.as_tensor(w).to(tdt), tile_m=tile_m)
    assert got.shape == (e, c, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype_name))
    if dtype_name == "float32":   # and the moe_apply einsum
        np.testing.assert_allclose(got.numpy(), np.einsum(
            "ecd,edf->ecf", xe, w), rtol=1e-4, atol=1e-4)


def test_group_matmul_plain_is_grouped_by_expert():
    """Each row uses the weights of its tile's expert, whatever the order
    of the tiles; an out-of-range expert gives NaN rows, as the kernel."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((24, 5)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((3, 5, 4)), dtype=torch.float32)
    eid = torch.tensor([2, 0, 2], dtype=torch.int32)
    got = group_matmul_plain(x, eid, w, tile_m=8)
    for i in range(3):
        torch.testing.assert_close(got[8 * i:8 * i + 8],
                                   x[8 * i:8 * i + 8] @ w[eid[i]])
    bad = group_matmul_plain(x, torch.tensor([0, 3, -1], dtype=torch.int32),
                             w, tile_m=8)
    assert not bad[:8].isnan().any() and bad[8:].isnan().all()


def test_group_matmul_checks_inputs():
    """Dtype, device, shape and expert ids are checked before any launch;
    a device without the kernel raises instead of falling back."""
    x = torch.ones((16, 4))
    w = torch.ones((2, 4, 8))
    eid = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        group_matmul(x.double(), eid, w.double(), tile_m=8)
    with pytest.raises(ValueError, match="dtype"):
        group_matmul(x, eid, w.bfloat16(), tile_m=8)
    with pytest.raises(ValueError, match="int32"):
        group_matmul(x, eid.long(), w, tile_m=8)
    with pytest.raises(ValueError, match="multiple of tile_m"):
        group_matmul(x, eid, w, tile_m=5)
    with pytest.raises(ValueError, match="expert_of_tile must be"):
        group_matmul(x, torch.zeros((3,), dtype=torch.int32), w, tile_m=8)
    with pytest.raises(ValueError, match=r"\(e, d, f\)"):
        group_matmul(x, eid, torch.ones((2, 5, 8)), tile_m=8)
    with pytest.raises(ValueError, match="expert ids"):
        group_matmul(x, torch.tensor([0, 2], dtype=torch.int32), w, tile_m=8)
    with pytest.raises(ValueError, match="expert ids"):
        group_matmul(x, torch.tensor([-1, 0], dtype=torch.int32), w,
                     tile_m=8)
    with pytest.raises(ValueError, match="one device"):
        group_matmul(x, eid.to("meta"), w, tile_m=8)
    with pytest.raises(ValueError, match="no group_matmul"):
        group_matmul(x.to("meta"), eid.to("meta"), w.to("meta"), tile_m=8)
    with pytest.raises(ValueError, match="w must be"):
        grouped_expert_matmul(torch.ones((2, 3, 4)), torch.ones((3, 4, 8)))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            group_matmul(x.to("cuda"), eid, w, tile_m=8)
