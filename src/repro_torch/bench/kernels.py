"""The kernel legs of the benchmark, on the port's kernels.

The port of the ``bcsr_spmm``, ``sddmm`` and ``group_matmul`` legs of the
reference's ``benchmarks/kernels.py``, at the benchmark's own shapes:

* ``bcsr_spmm``: a 1024 x 1024 A of 128 x 128 blocks at 12.5% block
  density times a dense (1024, 512) B;
* ``sddmm``: the 4096-token sparse-attention scores, d = 512, 128 x 128
  blocks at a 6% block mask (the reference cut the tokens to 256 for the
  CPU interpreter; the card runs the full case);
* ``group_matmul``: the phi-MoE expert product, 16 experts x capacity
  1024 tokens, d 1024 -> f 4096, ``tile_m`` 32 (the reference cut it to
  4 experts x 64 for the CPU interpreter; the card runs the full case).

Inputs come from ``numpy.random.default_rng(seed)`` in the reference's
draw order (the expert product's after the block-sparse legs').  Each
leg runs the kernel wrapper and holds it against the plain version on
the same inputs (rtol = atol = 1e-4 for f32, as the reference; 2e-2 for
bf16, as its kernel tests); the f32 ``bcsr_spmm`` leg is also held to
the scale layer's oracle, ``repro_torch.sparse.ops.bcsr_spmm``.

:func:`tc_exact` holds ``group_matmul``'s tensor-core shape to its plain
version bit for bit, in both layouts of ``w``, on integer-valued bf16
operands whose sums are exact in f32 (:data:`TC_EXACT_CASES`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import (bcsr_spmm, bcsr_spmm_plain, group_matmul,
                                 group_matmul_plain, sddmm_blocks,
                                 sddmm_blocks_plain)
from repro_torch.kernels.group_matmul import launch_shape
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.formats import BCSR

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the phi-MoE expert product of the reference benchmark
MOE_LEG = dict(e=16, c=8192 * 2 // 16, d=1024, f=4096, tile_m=32)


def leg_inputs(dtype=torch.float32, device="cuda", seed: int = 0) -> dict:
    """Both legs' operands, drawn in the reference's order."""
    rng = np.random.default_rng(seed)
    m = n = 1024
    k = 512
    bm = bn = 128
    mask = rng.random((m // bm, n // bn)) < 0.125
    a_dense = np.where(np.repeat(np.repeat(mask, bm, 0), bn, 1),
                       rng.standard_normal((m, n)), 0).astype(np.float32)
    a = BCSR.from_dense(a_dense, block=(bm, bn), dtype=dtype, device=device)
    b = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32),
                        device=device).to(dtype)

    s, d = 4096, 512
    nblk = int((s // bm) * (s // bn) * 0.06)
    brow = torch.as_tensor(rng.integers(0, s // bm, nblk).astype(np.int32),
                           device=device)
    bcol = torch.as_tensor(rng.integers(0, s // bn, nblk).astype(np.int32),
                           device=device)
    a2 = torch.as_tensor(rng.standard_normal((s, d)).astype(np.float32),
                         device=device).to(dtype)
    b2 = torch.as_tensor(rng.standard_normal((d, s)).astype(np.float32),
                         device=device).to(dtype)

    e, c, dm, f = (MOE_LEG[k] for k in ("e", "c", "d", "f"))
    tile_m = MOE_LEG["tile_m"]
    xe = rng.standard_normal((e * c, dm), dtype=np.float32)
    w = rng.standard_normal((e, dm, f), dtype=np.float32)
    eid = np.repeat(np.arange(e, dtype=np.int32), c // tile_m)
    return dict(bcsr_spmm=dict(a=a, b=b),
                sddmm_blocks=dict(brow=brow, bcol=bcol, a=a2, b=b2, bm=bm,
                                  bn=bn),
                group_matmul=dict(
                    x=torch.as_tensor(xe, device=device).to(dtype),
                    eid=torch.as_tensor(eid, device=device),
                    w=torch.as_tensor(w, device=device).to(dtype),
                    tile_m=tile_m))


def run_kernel(name: str, args: dict) -> torch.Tensor:
    """The kernel wrapper of a leg on its inputs."""
    if name == "bcsr_spmm":
        return bcsr_spmm(args["a"], args["b"])
    if name == "group_matmul":
        return group_matmul(args["x"], args["eid"], args["w"],
                            tile_m=args["tile_m"])
    return sddmm_blocks(args["brow"], args["bcol"], args["a"], args["b"],
                        bm=args["bm"], bn=args["bn"])


def run_plain(name: str, args: dict) -> torch.Tensor:
    """The plain PyTorch version of a leg on its inputs."""
    if name == "bcsr_spmm":
        return bcsr_spmm_plain(args["a"], args["b"])
    if name == "group_matmul":
        return group_matmul_plain(args["x"], args["eid"], args["w"],
                                  tile_m=args["tile_m"])
    return sddmm_blocks_plain(args["brow"], args["bcol"], args["a"],
                              args["b"], bm=args["bm"], bn=args["bn"])


def work(name: str, args: dict) -> dict:
    """FLOPs and bytes this leg's data needs: every live block's product,
    each needed input byte read once, the output written once."""
    if name == "bcsr_spmm":
        a, b = args["a"], args["b"]
        bm, bn = a.block
        k = b.shape[1]
        live = a.indices[:a.n_blocks]
        es = a.blocks.element_size()
        n_cols = int(torch.unique(live).numel())
        flops = 2 * a.n_blocks * bm * bn * k
        nbytes = (a.n_blocks * bm * bn * es + n_cols * bn * k * es
                  + (a.indptr.numel() + live.numel()) * 4
                  + a.shape[0] * k * 4)
    elif name == "group_matmul":
        x, w = args["x"], args["w"]
        t, d = x.shape
        es = x.element_size()
        # the weights of every expert that owns a tile, read once
        used = int(torch.unique(args["eid"]).numel())
        f = w.shape[2]
        flops = 2 * t * d * f
        nbytes = (t * d + used * d * f) * es + args["eid"].numel() * 4 \
            + t * f * 4
    else:
        bm, bn = args["bm"], args["bn"]
        a, b = args["a"], args["b"]
        d = a.shape[1]
        nblk = args["brow"].numel()
        es = a.element_size()
        rows = int(torch.unique(args["brow"]).numel())
        cols = int(torch.unique(args["bcol"]).numel())
        flops = 2 * nblk * bm * bn * d
        nbytes = ((rows * bm + cols * bn) * d * es + 2 * nblk * 4
                  + nblk * bm * bn * 4)
    return dict(flops=flops, bytes=nbytes)


def main(device="cuda", dtypes=(torch.float32, torch.bfloat16),
         seed: int = 0) -> dict:
    """Run both legs in every dtype; raise if a kernel disagrees with its
    plain version (or, the f32 ``bcsr_spmm``, with the oracle of
    ``sparse.ops``).  Returns ``{name: {dtype_name: max_abs_err}}``, and
    the oracle's under ``bcsr_spmm``'s ``"oracle_float32"``."""
    out: dict = {"bcsr_spmm": {}, "sddmm_blocks": {}, "group_matmul": {}}
    for dtype in dtypes:
        legs = leg_inputs(dtype, device, seed)
        for name, args in legs.items():
            got = run_kernel(name, args)
            want = run_plain(name, args)
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {dtype}: bad output")
            tol = TOL[dtype]
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                raise AssertionError(
                    f"{name} {dtype}: max |err| "
                    f"{(got - want).abs().max().item()} over tolerance {tol}")
            out[name][str(dtype).removeprefix("torch.")] = \
                (got - want).abs().max().item()
            if name == "bcsr_spmm" and dtype == torch.float32:
                oracle = sparse_ops.bcsr_spmm(args["a"], args["b"])
                err = (got - oracle).abs().max().item()
                if not torch.allclose(got, oracle, rtol=tol, atol=tol):
                    raise AssertionError(
                        f"bcsr_spmm {dtype}: max |err| {err} from the "
                        f"sparse.ops oracle over tolerance {tol}")
                out[name]["oracle_float32"] = err
    return out


#: tensor-core cases of the integer-exact check: tiles, tile_m, d, f,
#: experts.  tile_m 17 to 130 (one 64-row block with rows masked, two
#: 64-row halves of a 128-row block, a tile of two row blocks), d and f
#: multiples of 8 but not of 64 and not of the 256-column block, d up to
#: 1024 (|x|, |w| <= 8: every partial sum an integer under 2^24, exact in
#: f32 in any order); the expert ids change from tile to tile.
TC_EXACT_CASES = ((4, 128, 512, 384, 3), (6, 60, 256, 264, 4),
                  (5, 17, 136, 200, 3), (3, 130, 200, 136, 2),
                  (4, 64, 1024, 520, 2), (2, 32, 64, 8, 2))


def tc_exact(device="cuda", seed: int = 0, cases=TC_EXACT_CASES) -> dict:
    """``group_matmul`` on the tensor-core shape against the plain version
    in both layouts of ``w`` (as stored, and transposed and read in place)
    on integer-valued bf16 operands: the two must be equal bit for bit
    (raises otherwise).  Returns ``{case: shape launched}``."""
    rng = np.random.default_rng(seed)
    out = {}
    for tiles, tile_m, d, f, e in cases:
        def ints(*shape):
            return torch.as_tensor(rng.integers(-8, 9, shape),
                                   dtype=torch.bfloat16, device=device)
        x = ints(tiles * tile_m, d)
        eid = torch.as_tensor(np.arange(tiles) * 7 % e, dtype=torch.int32,
                              device=device)
        for trans_w, w in ((False, ints(e, d, f)), (True, ints(e, f, d))):
            name = f"t{tile_m}-d{d}-f{f}-{'wt' if trans_w else 'w'}"
            shape = launch_shape(x, w, tile_m=tile_m, trans_w=trans_w)
            got = group_matmul(x, eid, w, tile_m=tile_m, trans_w=trans_w)
            want = group_matmul_plain(x, eid, w, tile_m=tile_m,
                                      trans_w=trans_w)
            if not torch.equal(got, want):
                bad = (got != want).nonzero()
                raise AssertionError(
                    f"group_matmul {name} ({shape}): {len(bad)} of "
                    f"{got.numel()} outputs differ from the exact sums, "
                    f"first at {bad[0].tolist()}: {got[tuple(bad[0])]} "
                    f"against {want[tuple(bad[0])]}")
            out[name] = shape
    return out
