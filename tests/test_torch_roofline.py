"""The port's roofline (``repro_torch.launch.roofline``) and its per-rank
counter against the reference on the CPU.

* ``model_flops``, ``reconstruct_pair`` and ``RooflineTerms`` are copies
  of the reference's: the same source text, the same numbers for all 40
  (arch x shape) cells and for seeded inputs (the terms with the
  reference's constants set to the port's H100 figures);
* the counter's rule for ``DTensor``s: on a 512-rank ``fake`` process
  group a product of two sharded matrices counts rank 0's local product
  (1,048,576 FLOPs), not the global one beside it (537,919,488), and a
  redistribution counts its all-gather's local payload;
* ``repro_torch::group_matmul``: the operator equals the plain version,
  its fake implementation gives the kernel's shape and dtype, and the
  counter sees one operator of ``2 t d f`` FLOPs;
* DTensor's bookkeeping is wrapped only while a counter is entered;
* at ``reduced()`` width, every runnable kind of each of the ten configs
  (train with ``remat="none"``, prefill or encode, decode, and the long
  cell's decode for the Zamba2 hybrid and the xLSTM) counts exactly the
  FLOPs of the ``dot_general``s of the reference's jaxpr of the same
  step, ``scan`` bodies times their length, with the MoE's tile padding
  the one stated term: the kernel multiplies each expert's capacity
  ``c`` padded to ``cp``, a multiple of its tile (``tile_by_expert``),
  forward and in the backward's dx, so its products count ``cp / c``
  times the reference's.

  What torch does by multiplying, which no FLOP counter counts, is left
  out of the walk by rules on the jaxpr:

  - a product whose contraction has one term or none (an outer or
    broadcast product, one multiply per output), on both sides: torch's
    einsum multiplies there, and the gradient of a product with one
    operand whole over its contraction is a matrix product over one
    term, which the port's side sets apart;
  - the transposes of a forward product with no contracted dim, found by
    its source line and shapes: torch's gradient of a multiply
    multiplies and sums;
  - the products a transposed ``lax.scan`` runs that autograd does not:
    at its first step those fed by a carry that starts at zero (the
    cotangent of a final state nothing reads), at its last those that
    only a dropped carry reads (the gradient of a zero initial state).

  The last two are held to formulas from the shapes: the Zamba2 SSD's
  broadcast products and its scan's dead transposes, the xLSTM's outer
  products; every other config and kind has neither.  Under each
  config's ``TRAIN_POLICY`` the recompute's extra products are printed
  beside the ``remat="none"`` count, not held.
"""
import ast
import dataclasses
import inspect
import math
import os
from unittest import mock

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve import steps as ref_steps  # noqa: E402
from repro.train.optimizer import adamw_init as ref_adamw_init  # noqa: E402
from repro.train.step import make_train_step as ref_make_train_step  # noqa: E402
from repro.train.step import synth_batch as ref_synth_batch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import dryrun_check  # noqa: E402
from repro_torch.kernels.group_matmul import (group_matmul,  # noqa: E402
                                              group_matmul_plain)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

REF_DRYRUN = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                          "launch", "dryrun.py")
#: the reduced cells' sizes: batch, sequence (two SSD chunks of 8) and
#: the decode cache
BATCH, SEQ, CACHE = 2, 16, 64


# ---------------------------------------------------------------- copies --
@pytest.mark.parametrize("name", ["model_flops", "reconstruct_pair",
                                  "RooflineTerms"])
def test_copies_are_the_reference_source(name):
    assert inspect.getsource(getattr(rl, name)) == \
        inspect.getsource(getattr(ref_rl, name))


def test_model_flops_equal_the_reference_for_all_cells():
    cells = configs.cells()
    assert len(cells) == 40
    for arch, shape_id, _, _ in cells:
        seq, batch, kind = configs.SHAPES[shape_id]
        want = ref_rl.model_flops(ref_configs.get_arch(arch), seq, batch,
                                  kind)
        assert rl.model_flops(configs.get_arch(arch), seq, batch,
                              kind) == want, (arch, shape_id)


def test_reconstruct_pair_and_terms_equal_the_reference(monkeypatch):
    for name, value in (("PEAK_FLOPS", rl.PEAK_FLOPS),
                        ("HBM_BW", rl.HBM_BW), ("ICI_BW", rl.ICI_BW)):
        monkeypatch.setattr(ref_rl, name, value)
    rng = np.random.default_rng(23)
    for _ in range(50):
        f1, f2 = rng.uniform(0, 1e15, size=2)
        n = int(rng.integers(1, 100))
        assert rl.reconstruct_pair(f1, f2, n) == \
            ref_rl.reconstruct_pair(f1, f2, n)
        kw = dict(flops=rng.uniform(1e9, 1e16),
                  hbm_bytes=rng.uniform(1e6, 1e13),
                  coll_bytes=rng.uniform(0, 1e11),
                  coll_breakdown={"all-gather": 1.0},
                  chips=int(rng.choice([1, 256, 512])),
                  model_flops=rng.uniform(1e9, 1e18))
        assert rl.RooflineTerms(**kw).row() == \
            ref_rl.RooflineTerms(**kw).row()


def test_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW, rl.NVLINK_BW) == \
        (989e12, 3.35e12, 50e9, 450e9)


def test_train_policy_equals_the_reference():
    """Read from the reference's file: importing it would force 512 XLA
    host devices on the whole test process."""
    tree = ast.parse(open(REF_DRYRUN).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "TRAIN_POLICY":
            assert ast.literal_eval(node.value) == dryrun.TRAIN_POLICY
            return
    raise AssertionError("no TRAIN_POLICY in the reference's dry run")


# ---------------------------------------------------- the DTensor rule --
def test_counter_counts_rank_zero_local_ops_on_a_fake_group():
    """The probe: x (64, 1024) split over (pod, data) times w (1024, 4096)
    split over model, on 512 fake ranks.  Rank 0's product is (2, 1024)
    @ (1024, 256); the global op's 2 * 64 * 1024 * 4096 is not counted,
    nor is DTensor's propagation of its metadata (torch's own
    ``FlopCounterMode`` counts both, 537,919,488).  Gathering the product
    over ``model`` is one all-gather of rank 0's (2, 256) f32 shard."""
    import torch.distributed as dist
    got = dryrun_check.skip_rule_probe("cpu")
    assert not dist.is_initialized()
    assert got["product_flops"] == 1_048_576
    assert got["product_collectives"] == 0
    assert got["gather_flops"] == 0
    assert got["gather_bytes"] == {"all-gather": 2 * 256 * 4,
                                   "all-reduce": 0, "reduce-scatter": 0,
                                   "all-to-all": 0, "collective-permute": 0}
    assert got["gathered_local_shape"] == (2, 4096)


def _bookkeeping_methods() -> dict:
    import importlib
    out = {}
    for mod, cls_name, name, _ in rl._BOOKKEEPING:
        cls = getattr(importlib.import_module(mod), cls_name, None)
        if cls is not None and name in cls.__dict__:
            out[f"{cls_name}.{name}"] = cls.__dict__[name]
    return out


def test_counter_gives_dtensor_its_methods_back():
    """DTensor's bookkeeping is marked only while a counter is entered:
    torch's own methods before, wrapped inside (a nested counter keeps
    them wrapped), and torch's own again once the last counter exits,
    by an exception too.  Every name the counter wraps exists on this
    torch, so none is silently skipped."""
    before = _bookkeeping_methods()
    assert len(before) == len(rl._BOOKKEEPING)
    with rl.Counter():
        with rl.Counter():
            inner = _bookkeeping_methods()
        outer = _bookkeeping_methods()
    assert all(inner[k] is not before[k] for k in before)
    assert all(outer[k] is inner[k] for k in before)
    assert all(v is before[k] for k, v in _bookkeeping_methods().items())
    with pytest.raises(RuntimeError):
        with rl.Counter():
            raise RuntimeError("inside")
    assert all(v is before[k] for k, v in _bookkeeping_methods().items())
    assert rl._ENTERED == [0] and not rl._PATCHED


def test_counter_bytes_and_temporaries():
    """Eager bytes: each op's operands read and results written, views
    and allocations free; the peak counts the storage made inside."""
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    with rl.Counter() as c:
        v = a.view(16, 8).t()         # a view: nothing moves
        y = a @ b                     # 512 + 256 read, 128 written
        y.add_(1.0)                   # in place: 128 read, 128 written
        del v
    assert c.flops == 2 * 8 * 16 * 4
    assert c.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4 + 2 * 8 * 4 * 4
    assert c.peak_bytes == 8 * 4 * 4
    assert y.shape == (8, 4)


# ------------------------------------------------- the custom operator --
def test_group_matmul_operator_matches_plain_and_counts_its_rows():
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator().manual_seed(3)
    t, d, f, e, tile_m = 48, 24, 40, 3, 16
    x = torch.randn(t, d, generator=gen)
    w = torch.randn(e, d, f, generator=gen)
    eid = torch.tensor([2, 0, 1], dtype=torch.int32)
    with rl.Counter() as c:
        got = group_matmul(x, eid, w, tile_m=tile_m)
    want = group_matmul_plain(x, eid, w, tile_m=tile_m)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert c.flops == 2 * t * d * f
    assert c.flops_by_op == {"repro_torch.group_matmul": 2 * t * d * f}
    assert c.ops == 1
    with FakeTensorMode():
        fx = torch.empty(t, d, dtype=torch.bfloat16)
        fw = torch.empty(e, d, f, dtype=torch.bfloat16)
        feid = torch.empty(e, dtype=torch.int32)
        with rl.Counter() as c:
            out = group_matmul(fx, feid, fw, tile_m=tile_m)
    assert out.shape == (t, f) and out.dtype == torch.float32
    assert c.flops == 2 * t * d * f


# ------------------------------------ reduced FLOPs against the jaxpr --
#: the ops whose result is zero when every operand is (``mul`` and
#: ``dot_general``: when any is)
_ZERO_IF_ALL = {"add", "add_any", "sub", "neg", "convert_element_type",
                "transpose", "reshape", "broadcast_in_dim", "squeeze",
                "expand_dims", "reduce_sum", "copy", "copy_p"}


def _dot(eqn) -> tuple:
    """(FLOPs, terms of its contraction) of a ``dot_general``:
    2 * |out| * |contracted|."""
    (lc, _), _ = eqn.params["dimension_numbers"]
    k = math.prod(eqn.invars[0].aval.shape[i] for i in lc)
    return 2 * math.prod(eqn.outvars[0].aval.shape) * k, k


def _line(eqn) -> str:
    """The reference's source line of an equation (a transpose keeps its
    forward equation's)."""
    for f in eqn.source_info.traceback.frames:
        if f"{os.sep}repro{os.sep}" in f.file_name:
            return f"{f.file_name}:{f.line_num}"
    return "?"


def _walk(jaxpr, mult=1, backward=False, dots=None, scans=None) -> tuple:
    """Every ``dot_general`` of a jaxpr as (equation, times run, in the
    backward), sub-jaxprs included and ``scan`` bodies times their
    length, and every ``scan`` as (equation, times run, in the backward,
    the jaxpr that holds it); the backward is what an equation named
    ``transpose(...)`` holds."""
    dots = [] if dots is None else dots
    scans = [] if scans is None else scans
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        bwd = backward or "transpose" in str(eqn.source_info.name_stack)
        if name == "while":
            raise AssertionError("a while loop has no static trip count")
        if name == "dot_general":
            dots.append((eqn, mult, bwd))
        if name == "scan":
            scans.append((eqn, mult, bwd, jaxpr))
        m = mult * (eqn.params["length"] if name == "scan" else 1)
        for v in eqn.params.values():
            for j in (v if isinstance(v, (list, tuple)) else [v]):
                j = j if hasattr(j, "eqns") else getattr(j, "jaxpr", None)
                if hasattr(j, "eqns"):
                    _walk(j, m, bwd, dots, scans)
    return dots, scans


def _broadcast_grads(dots) -> set:
    """The backward's products that are gradients of a forward product
    with no contracted dim: its transposes, each the cotangent of the
    forward output times one operand, shaped as the other, at the
    forward's source line.  torch's einsum multiplies there, and its
    gradient multiplies and sums."""
    def key(*shapes):
        return sorted(tuple(x) for x in shapes)

    fwd: dict = {}
    for eqn, _, bwd in dots:
        if not bwd:
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs, rhs = (v.aval.shape for v in eqn.invars)
            fwd.setdefault(_line(eqn), []).append(
                (not lc, lhs, rhs, eqn.outvars[0].aval.shape))
    grads = set()
    for eqn, _, bwd in dots:
        if not bwd:
            continue
        ins = key(*(v.aval.shape for v in eqn.invars))
        size = math.prod(eqn.outvars[0].aval.shape)
        of = {broadcast for broadcast, lhs, rhs, out in fwd.get(_line(eqn), ())
              if (ins == key(out, rhs) and size == math.prod(lhs))
              or (ins == key(out, lhs) and size == math.prod(rhs))}
        assert len(of) <= 1, f"an ambiguous transpose at {_line(eqn)}"
        if of == {True}:
            grads.add(id(eqn))
    return grads


def _is_zero(v, defs) -> bool:
    """Whether a jaxpr value is a zero made in place: a literal 0, or
    one broadcast, converted or reshaped."""
    if isinstance(v, jcore.Literal):
        return not np.any(np.asarray(v.val))
    eqn = defs.get(v)
    return eqn is not None and eqn.primitive.name in (
        "broadcast_in_dim", "convert_element_type", "reshape") and \
        _is_zero(eqn.invars[0], defs)


def _dead_products(scans, counted) -> int:
    """FLOPs of the products a transposed ``scan`` runs that autograd
    does not, as ``lax.scan`` transposes its whole body at every step: at
    its first step those fed by a carry that starts at zero (the
    cotangent of a final state nothing reads), at its last those that
    only a dropped carry reads (the gradient of a zero initial state)."""
    total = 0
    for s, n, bwd, parent in scans:
        if not (bwd and s.params["reverse"]):
            continue
        body = s.params["jaxpr"].jaxpr
        nc, nk = s.params["num_consts"], s.params["num_carry"]
        defs = {o: e for e in parent.eqns for o in e.outvars}
        used = {v for e in parent.eqns for v in e.invars
                if not isinstance(v, jcore.Literal)} | {
                    v for v in parent.outvars
                    if not isinstance(v, jcore.Literal)}
        zeros = {body.invars[nc + i] for i in range(nk)
                 if _is_zero(s.invars[nc + i], defs)}
        steps: dict = {}          # id -> [product, steps it runs dead]
        for e in body.eqns:
            hit = [v in zeros for v in e.invars
                   if not isinstance(v, jcore.Literal)]
            if e.primitive.name in ("mul", "dot_general") and any(hit) or \
                    e.primitive.name in _ZERO_IF_ALL and hit and all(hit):
                zeros.update(e.outvars)
                if e.primitive.name == "dot_general" and counted(e):
                    steps.setdefault(id(e), [e, 0])[1] += 1
        live = {v for i, v in enumerate(body.outvars)
                if not isinstance(v, jcore.Literal)
                and (i >= nk or s.outvars[i] in used)}
        for e in reversed(body.eqns):
            if any(o in live for o in e.outvars):
                live.update(v for v in e.invars
                            if not isinstance(v, jcore.Literal))
            elif e.primitive.name == "dot_general" and counted(e):
                steps.setdefault(id(e), [e, 0])[1] += 1
        total += n * sum(_dot(e)[0] * min(s.params["length"], k)
                         for e, k in steps.values())
    return total


def _ref_counts(jaxpr) -> dict:
    """The reference's products against which the port's counter is held
    (``counted``), and FLOPs left out of it: beside the ``dot_general``s
    with a contraction of one term or none (an outer or broadcast
    product, one multiply per output, which torch's einsum multiplies or
    a matrix product over one term computes, left out on the port's side
    too), the gradients of those with no contracted dim
    (``broadcast_grads``: torch multiplies and sums) and the products a
    transposed ``scan`` runs for nothing (``dead``)."""
    dots, scans = _walk(jaxpr)
    grads = _broadcast_grads(dots)

    def counted(e):
        return _dot(e)[1] > 1 and id(e) not in grads

    dead = _dead_products(scans, counted)
    return dict(
        counted=sum(_dot(e)[0] * n for e, n, _ in dots if counted(e)) - dead,
        broadcast_grads=sum(_dot(e)[0] * n for e, n, _ in dots
                            if id(e) in grads and _dot(e)[1] > 1),
        dead=dead)


def _ref_flops(rcfg, kind: str) -> dict:
    params = ref_lm.shape_params(rcfg)
    if kind == "train":
        batch = jax.eval_shape(lambda: ref_synth_batch(rcfg, BATCH, SEQ))
        opt = jax.eval_shape(ref_adamw_init, params)
        jx = jax.make_jaxpr(ref_make_train_step(rcfg))(params, opt, batch)
    elif kind == "prefill" and rcfg.encoder_only:
        frames = jax.ShapeDtypeStruct((BATCH, SEQ, 512), jnp.bfloat16)
        jx = jax.make_jaxpr(ref_steps.encode_step(rcfg))(params, frames)
    elif kind == "prefill" and rcfg.frontend == "vision":
        def step(params, tokens, patches):
            caches = ref_lm.make_caches(rcfg, BATCH, SEQ + rcfg.n_patches)
            logits, caches, _ = ref_lm.forward(
                params, rcfg, {"tokens": tokens, "patches": patches},
                caches=caches, cache_index=jnp.int32(0))
            return logits[:, -1, :], caches
        jx = jax.make_jaxpr(step)(
            params, jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32),
            jax.ShapeDtypeStruct((BATCH, rcfg.n_patches, rcfg.d_frontend),
                                 jnp.bfloat16))
    elif kind == "prefill":
        jx = jax.make_jaxpr(ref_steps.make_prefill_step(rcfg, SEQ))(
            params, jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32))
    else:
        b = 1 if kind == "long" else BATCH
        caches = jax.eval_shape(lambda: ref_lm.make_caches(rcfg, b, CACHE))
        jx = jax.make_jaxpr(ref_steps.make_decode_step(rcfg))(
            params, caches, jax.ShapeDtypeStruct((b, 1), jnp.int32),
            jnp.int32(0))
    return _ref_counts(jx.jaxpr)


def _moe_padding(cfg, kind: str) -> int:
    """The expert products' extra FLOPs over the reference's: each
    expert's capacity ``c`` padded to ``cp`` rows (``tile_by_expert``), in
    the three forward products and, in training, their three dx."""
    if cfg.moe is None:
        return 0
    m = cfg.moe
    tokens = {"train": BATCH * SEQ, "prefill": BATCH * SEQ,
              "decode": BATCH, "long": 1}[kind]
    c = int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor))
    tile_m = min(128, max(8, c))
    cp = -(-c // tile_m) * tile_m
    per_fwd = 3 * 2 * m.n_experts * (cp - c) * cfg.d_model * m.d_expert
    return cfg.n_layers * per_fwd * (2 if kind == "train" else 1)


def _ssd_terms(cfg) -> dict:
    """What the reference's Zamba2 training step should leave out, from
    the shapes, per Mamba-2 layer: its chunked SSD's two broadcast
    products (C times its decay and B times its remainder over (B, t, nh,
    ds), at every chunk), each with a transpose over ``ds``; and the
    transposes of its scan's body on the zero cotangent of the final
    state (the state update's two, at the last chunk) and for the
    dropped gradient of the zero initial state (the inter-chunk product's
    one, at the first)."""
    s = cfg.ssm
    t = min(s.chunk, SEQ)
    nc = SEQ // t
    nh, ds = s.n_heads, s.d_state
    hp = s.expand * cfg.d_model // nh
    return dict(
        broadcast_grads=cfg.n_layers * nc * 2 * (2 * BATCH * t * nh * ds),
        dead=cfg.n_layers * 3 * (2 * BATCH * t * nh * hp * ds))


def _mlstm_terms(cfg) -> dict:
    """What the reference's xLSTM training step should leave out, from
    the shapes: each mLSTM layer's outer product v k^T over (B, nh, hp,
    hp), at every token, has two transposes over ``hp``; its scan's body
    runs nothing dead (the zero cotangent of the final state only meets
    an addition)."""
    nm = (cfg.n_layers + 1) // 2
    hp = 2 * cfg.d_model // cfg.n_heads
    return dict(broadcast_grads=nm * SEQ * 2 * (2 * BATCH * cfg.n_heads
                                                * hp * hp), dead=0)


def _kinds(cfg) -> list:
    kinds = ["train", "prefill"]
    if not cfg.encoder_only:
        kinds.append("decode")
    if cfg.ssm is not None or cfg.xlstm:
        kinds.append("long")
    return kinds


CASES = [(a, k) for a in configs.ARCH_IDS
         for k in _kinds(configs.get_arch(a))]


class _UnitApart(rl.Counter):
    """The counter, with the FLOPs of its matrix products over a single
    term kept apart (``unit``: the gradient of a product with one operand
    whole over a contraction is an outer product)."""

    #: the matrix products and the argument whose last dim they contract
    CONTRACTS = {torch.ops.aten.mm: 0, torch.ops.aten.bmm: 0,
                 torch.ops.aten.addmm: 1, torch.ops.aten.baddbmm: 1}

    def __init__(self):
        super().__init__()
        self.unit = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        arg = self.CONTRACTS.get(func._overloadpacket)
        if arg is not None and args[arg].shape[-1] == 1:
            self.unit += self.flops - before
        return out


def _port_flops(cfg, kind: str) -> int:
    """The port's counted FLOPs with its products over a single term left
    out, as the reference's are."""
    seq = CACHE if kind in ("decode", "long") else SEQ
    batch = 1 if kind == "long" else BATCH
    with mock.patch.object(rl, "Counter", _UnitApart):
        counter, _, _ = dryrun.count_step(cfg, kind, seq, batch, None,
                                          device="cpu")
    return counter.flops - counter.unit


@pytest.mark.parametrize("arch,kind", CASES)
def test_reduced_flops_equal_the_reference_jaxpr(arch, kind):
    cfg = dataclasses.replace(configs.get_arch(arch).reduced(), remat="none")
    rcfg = dataclasses.replace(ref_configs.get_arch(arch).reduced(),
                               remat="none")
    port = _port_flops(cfg, kind)
    ref = _ref_flops(rcfg, kind)
    padding = _moe_padding(cfg, kind)
    if kind == "train" and cfg.xlstm:
        want = _mlstm_terms(cfg)
    elif kind == "train" and cfg.ssm is not None:
        want = _ssd_terms(cfg)
    else:
        want = dict(broadcast_grads=0, dead=0)
    assert {k: ref[k] for k in want} == want
    assert port == ref["counted"] + padding, (port, ref, padding)
    if kind == "train":
        remat = dryrun.TRAIN_POLICY[arch][0]
        recomputed = _port_flops(dataclasses.replace(cfg, remat=remat),
                                 kind)
        print(f"{arch} train: remat=none {port}, remat={remat} "
              f"{recomputed} (+{recomputed - port} recomputed)")
