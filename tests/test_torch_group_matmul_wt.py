"""The grouped matmul with ``w`` transposed (``trans_w``: ``x[i] @
w[e]^T``, the expert products' dx), on the CPU: the port's plain version
against the reference's Pallas kernel in interpret mode on the swapped
weights, the port's ``GroupedExpertMatmul`` dx against ``jax.vjp`` of the
reference's einsum, and the operator's fake implementation and FLOP count
in both layouts.  The CUDA kernel's transposed layout is tested on the
card by ``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import group_matmul as ref_group_matmul  # noqa: E402

from repro_torch.kernels import (group_matmul, group_matmul_plain,  # noqa: E402
                                 grouped_expert_matmul)
from repro_torch.launch import roofline as rl  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # the reference kernel tests' tolerances: f32 1e-5 (only the summation
    # order differs), bf16 2e-2 (both sides widen the same bf16 inputs)
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("tiles,tile_m,d,f,e", [
    (4, 8, 32, 64, 3),       # d, f multiples of 8
    (3, 24, 40, 16, 2),      # a tile of more than 16 rows
    (2, 8, 100, 72, 2),      # unaligned d / f
])
def test_trans_w_matches_reference_on_swapped_weights(tiles, tile_m, d, f,
                                                      e, dtype_name):
    """``group_matmul(x, eid, w, trans_w=True)`` with ``x`` (t, f) and
    ``w`` (e, d, f) against the reference's kernel (interpret mode) on
    ``jnp.swapaxes(w, 1, 2)``: out (t, d)."""
    rng = np.random.default_rng(tiles * 100 + d + f)
    jdt, tdt = DTYPES[dtype_name]
    x = rng.standard_normal((tiles * tile_m, f)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    eid = rng.integers(0, e, tiles).astype(np.int32)
    want = np.asarray(ref_group_matmul(
        jnp.asarray(x).astype(jdt), jnp.asarray(eid),
        jnp.swapaxes(jnp.asarray(w).astype(jdt), 1, 2), tile_m=tile_m,
        interpret=True), np.float32)
    before = group_matmul.launches
    got = group_matmul(torch.as_tensor(x).to(tdt), torch.as_tensor(eid),
                       torch.as_tensor(w).to(tdt), tile_m=tile_m,
                       trans_w=True)
    assert got.dtype == torch.float32 and got.shape == (tiles * tile_m, d)
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype_name))
    assert group_matmul.launches == before   # the CPU path launches nothing


#: the dx cases' operands: 3 experts, d 24, f 40, up to 130 capacity slots
DX_E, DX_D, DX_F, DX_C = 3, 24, 40, 130
_DX_REF: dict = {}


def _dx_reference(dtype_name):
    """The operands at the largest capacity and ``jax.vjp`` of the
    reference's ``ecd,edf->ecf`` einsum on them, in the parameters' dtype
    (computed once a dtype: a row of dx depends on its own row of the
    cotangent only, so a case of capacity c takes the first c rows)."""
    if dtype_name not in _DX_REF:
        rng = np.random.default_rng(11)
        jdt, _ = DTYPES[dtype_name]
        xe = rng.standard_normal((DX_E, DX_C, DX_D)).astype(np.float32)
        w = (rng.standard_normal((DX_E, DX_D, DX_F))
             / np.sqrt(DX_D)).astype(np.float32)
        cot = rng.standard_normal((DX_E, DX_C, DX_F)).astype(np.float32)
        _, vjp = jax.vjp(lambda a: jnp.einsum("ecd,edf->ecf", a,
                                              jnp.asarray(w).astype(jdt)),
                         jnp.asarray(xe).astype(jdt))
        (dx,) = vjp(jnp.asarray(cot).astype(jdt))
        _DX_REF[dtype_name] = xe, w, cot, np.asarray(dx, np.float32)
    return _DX_REF[dtype_name]


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("tile_m,c", [
    (8, 5), (8, 8), (8, 11),          # capacities below, at and past a tile
    (60, 40), (60, 60), (60, 70),
    (128, 100), (128, 128), (128, 130)])
def test_grouped_dx_matches_reference_vjp(tile_m, c, dtype_name):
    """``GroupedExpertMatmul``'s dx (now one ``trans_w`` product) against
    ``jax.vjp`` of the reference's ``ecd,edf->ecf`` einsum, in the
    parameters' dtype, with the capacity padded to ``tile_m`` and cut
    back."""
    _, tdt = DTYPES[dtype_name]
    xe, w, cot, want = _dx_reference(dtype_name)
    x_t = torch.as_tensor(xe[:, :c]).to(tdt).requires_grad_()
    w_t = torch.as_tensor(w).to(tdt).requires_grad_()
    y = grouped_expert_matmul(x_t, w_t, tile_m=tile_m)
    y.backward(torch.as_tensor(cot[:, :c]))
    assert x_t.grad.dtype == tdt and x_t.grad.shape == (DX_E, c, DX_D)
    np.testing.assert_allclose(x_t.grad.float().numpy(), want[:, :c],
                               **_tol(dtype_name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trans_w_bit_equal_to_transposed_copy(dtype):
    """The plain version (and the CPU operator) with ``trans_w`` equals
    the plain version on the contiguous transposed copy bit for bit, NaN
    rows of an out-of-range expert id included."""
    rng = np.random.default_rng(3)
    tiles, tile_m, d, f, e = 5, 24, 40, 56, 3
    x = torch.as_tensor(rng.standard_normal((tiles * tile_m, f))).to(dtype)
    w = torch.as_tensor(rng.standard_normal((e, d, f))).to(dtype)
    eid = torch.tensor([2, 0, 1, 2, 5], dtype=torch.int32)
    wt = w.transpose(1, 2).contiguous()
    want = group_matmul_plain(x, eid, wt, tile_m=tile_m)
    got = group_matmul_plain(x, eid, w, tile_m=tile_m, trans_w=True)
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert torch.isnan(got[-tile_m:]).all()
    ok = eid[:-1]
    assert torch.equal(
        group_matmul(x[:-tile_m], ok, w, tile_m=tile_m, trans_w=True),
        group_matmul_plain(x[:-tile_m], ok, wt, tile_m=tile_m))


@pytest.mark.parametrize("trans_w", [False, True])
def test_fake_shape_and_flops_in_both_layouts(trans_w):
    """The operator's fake implementation gives (t, f) f32, or (t, d)
    transposed, and the counter counts ``2 t d f`` for a real and a fake
    call in either layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tiles, tile_m, d, f, e = 3, 16, 24, 40, 2
    x = torch.ones((tiles * tile_m, f if trans_w else d))
    w = torch.ones((e, d, f))
    eid = torch.zeros((tiles,), dtype=torch.int32)
    with rl.Counter() as real:
        got = group_matmul(x, eid, w, tile_m=tile_m, trans_w=trans_w)
    with FakeTensorMode() as mode:
        fx, feid, fw = (mode.from_tensor(t) for t in (x, eid, w))
        with rl.Counter() as fake:
            out = group_matmul(fx, feid, fw, tile_m=tile_m, trans_w=trans_w)
    n = d if trans_w else f
    assert got.shape == out.shape == (tiles * tile_m, n)
    assert out.dtype == torch.float32
    assert real.flops_by_op == fake.flops_by_op == {
        "repro_torch.group_matmul": 2 * tiles * tile_m * d * f}


def test_trans_w_checks_shapes():
    """``x`` must have ``w``'s last dimension when transposed."""
    w = torch.ones((2, 24, 40))
    eid = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(t, f\)"):
        group_matmul(torch.ones((8, 24)), eid, w, tile_m=8, trans_w=True)
    with pytest.raises(ValueError, match=r"\(t, d\)"):
        group_matmul(torch.ones((8, 40)), eid, w, tile_m=8)
