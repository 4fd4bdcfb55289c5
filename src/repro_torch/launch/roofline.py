"""Roofline terms of a dry-run record, and the per-rank counter that
measures them (the port of the reference's ``repro/launch/roofline.py``).

Terms per (arch x shape x mesh), NVIDIA H100 SXM constants:

    T_compute = FLOPs            / 989e12 FLOP/s (bf16 dense, tensor cores)
    T_memory  = eager bytes      / 3.35e12 B/s   (HBM3)
    T_coll    = collective bytes / 50e9 B/s      (one link, an assumption)

The link figure is an assumption: it cannot be measured on one card.  It
is one 400 Gb/s NDR InfiniBand port, a GPU's link to other nodes, since
every 16-wide axis of the production mesh spans several 8-card nodes;
inside a node NVLink 4 moves 450e9 B/s each way (:data:`NVLINK_BW`).

Sources.  The reference reads XLA's ``cost_analysis()`` and parses the
post-SPMD HLO text.  Eager PyTorch has neither, so :class:`Counter`, a
``TorchDispatchMode``, counts what one rank runs:

  * it skips every op whose arguments hold a ``DTensor`` (the global op,
    whose local ops follow) and the ops that ``DTensor`` runs on global
    shapes only to derive an output's metadata, and counts rank 0's local
    ops alone, so every number is per device, as XLA's per-device
    program's;
  * FLOPs from ``torch.utils.flop_counter``'s formulas (matrix products,
    attention and convolutions; elementwise work counts nothing there, as
    in XLA's ``dot`` FLOPs), with ``repro_torch::group_matmul`` a leaf
    whose formula counts the rows the kernel multiplies;
  * bytes: each op that moves data (not a view, not an allocation) reads
    its tensor operands and writes its tensor results, the traffic of an
    unfused eager program ("eager bytes"), not XLA's fused ``bytes
    accessed``;
  * collective payload: the local operand bytes of each
    ``_c10d_functional`` collective, under the reference's five keys;
  * the high-water mark of the local storage allocated while it is on
    (the record's ``temp_bytes`` with the arguments excluded).

Every count is a host-side walk: it reads shapes and dtypes only, so the
same step on fake tensors and on the card counts the same.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.context import is_sharded

PEAK_FLOPS = 989e12       # bf16 dense per card (H100 SXM)
HBM_BW = 3.35e12          # B/s per card (HBM3)
ICI_BW = 50e9             # B/s per link: one 400 Gb/s NDR port (assumed)
NVLINK_BW = 450e9         # B/s one way inside an 8-card node (NVLink 4)

COLLECTIVE_KEYS = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: ops that move no data: allocations, waits and metadata queries
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "device", "layout",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "size", "stride", "dim", "is_contiguous", "numel",
               "storage_offset", "is_strides_like_format",
               "is_non_overlapping_and_dense", "sym_is_contiguous"}

_PROPAGATING = threading.local()
_PATCH_LOCK = threading.Lock()
#: the methods of :data:`_BOOKKEEPING` replaced while a counter is
#: entered, ``(class, name) -> original``, and how many counters are
_PATCHED: dict = {}
_ENTERED = [0]


def _depth() -> int:
    return getattr(_PROPAGATING, "depth", 0)


def _not_the_ranks_work(fn, *, real: bool = False):
    """``fn`` (DTensor's own bookkeeping) with the ops inside it marked as
    not the rank's work; with ``real``, run outside any fake tensor mode
    (it builds index tensors and reads them back on the host)."""
    def wrapped(*args, **kwargs):
        _PROPAGATING.depth = _depth() + 1
        try:
            if not real:
                return fn(*args, **kwargs)
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1
    return wrapped


#: DTensor's bookkeeping that runs ops the rank's program does not:
#: (module, class, method, run outside fake tensors).  The metadata
#: propagation runs each op on global shapes; torch 2.13's redistribution
#: planner computes a ``_StridedShard``'s offsets from an index tensor
#: that it reads back, which a fake tensor cannot give.  A torch without
#: one of these names has no such step.
_BOOKKEEPING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached", False),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta", False),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset", True),
)


def _patch_propagator() -> None:
    """Wrap DTensor's bookkeeping (:data:`_BOOKKEEPING`) as the first
    counter is entered (:func:`_unpatch_propagator` restores it)."""
    import importlib
    with _PATCH_LOCK:
        _ENTERED[0] += 1
        if _ENTERED[0] > 1:
            return
        for mod, cls_name, name, real in _BOOKKEEPING:
            cls = getattr(importlib.import_module(mod), cls_name, None)
            fn = None if cls is None else cls.__dict__.get(name)
            if callable(fn):
                _PATCHED[(cls, name)] = fn
                setattr(cls, name, _not_the_ranks_work(fn, real=real))


def _unpatch_propagator() -> None:
    """Give DTensor its own methods back when the last counter exits."""
    with _PATCH_LOCK:
        _ENTERED[0] -= 1
        if _ENTERED[0]:
            return
        for (cls, name), fn in _PATCHED.items():
            setattr(cls, name, fn)
        _PATCHED.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Per-rank FLOPs, eager bytes, collective payload and peak temporary
    storage of the ops run while it is entered (see the module's
    docstring).  Enter it inside any ``FakeTensorMode``, so that it sees
    each op before the fake tensors' own dispatch.  DTensor's bookkeeping
    (:data:`_BOOKKEEPING`) is wrapped from the first counter entered to
    the last one exited, in every thread, and is torch's own again after.

    ``flops_by_op`` and ``bytes_by_op`` break the totals down by operator
    (``"aten.mm"``, ``"repro_torch.group_matmul"``); ``ops`` counts the
    ops that moved data (views, allocations and metadata queries, which
    fake tensors dispatch and real ones may not, are left out)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = {k: 0 for k in COLLECTIVE_KEYS}
        self.flops_by_op: dict = {}
        self.bytes_by_op: dict = {}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: set = set()

    def __enter__(self):
        if torch.distributed.is_available():
            _patch_propagator()
        try:
            return super().__enter__()
        except BaseException:
            if torch.distributed.is_available():
                _unpatch_propagator()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if torch.distributed.is_available():
                _unpatch_propagator()

    @property
    def collective_total(self) -> int:
        return sum(self.collective_bytes.values())

    def _track(self, t: torch.Tensor) -> None:
        """Count a result's storage as live until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(is_sharded(a) for a in flat):
            # the global op: DTensor's own dispatch runs the local ops
            # (and its redistributions), which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if _depth():
            return out              # metadata propagation on global shapes
        packet = func._overloadpacket
        name = str(packet)
        formula = self._flop_registry.get(packet)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        op = packet.__name__
        if getattr(func, "namespace", "") == "_c10d_functional" and \
                op in _COLLECTIVES:
            self.collective_bytes[_COLLECTIVES[op]] += sum(
                _nbytes(a) for a in tree_flatten(args)[0]
                if isinstance(a, torch.Tensor))
        if func.is_view or op in _NO_TRAFFIC:
            return out
        # a meta tensor (shapes only, no storage on any device) moves nothing
        ins = [a for a in flat if isinstance(a, torch.Tensor)
               and a.device.type != "meta"]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)
                and t.device.type != "meta"]
        if not (ins or outs):
            return out
        self.ops += 1
        moved = sum(_nbytes(a) for a in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += moved
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + moved
        written = {id(a.untyped_storage()) for a in ins}   # in place
        for t in outs:
            if id(t.untyped_storage()) not in written:
                self._track(t)
        return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # total per-device FLOPs (corrected)
    hbm_bytes: float           # total per-device bytes (corrected)
    coll_bytes: float          # per-device collective payload bytes
    coll_breakdown: dict
    chips: int
    model_flops: float         # analytic 6·N·D (or 6·N_active·D)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (remat & redundancy waste detector)."""
        return self.model_flops / max(self.flops * self.chips, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Roofline fraction: useful FLOP rate at the bound, vs peak."""
        per_chip_useful = self.model_flops / self.chips
        return per_chip_useful / (self.bound_time * PEAK_FLOPS)

    def row(self) -> dict:
        return dict(
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, dominant=self.dominant,
            model_flops=self.model_flops,
            useful_frac=self.useful_flops_frac, mfu_bound=self.mfu_bound,
            coll_breakdown=self.coll_breakdown)


def model_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training, 2·N·D for inference
    (+ attention quadratic term where applicable)."""
    n = cfg.active_param_count()
    tokens = seq * batch
    mult = 6.0 if kind == "train" else 2.0
    base = mult * n * tokens
    # attention O(S^2) term: 2 * 2 * L * H * hd * S^2 * B per pass
    if not cfg.xlstm and cfg.ssm is None:
        att = (2 if kind == "train" else 1)
        causal = 0.5
        base += att * 3 * 2 * cfg.n_layers * cfg.n_heads * cfg.hd \
            * seq * seq * batch * causal
    if kind in ("decode", "long"):
        # one token against a seq-long cache
        n_tok = batch
        base = mult * n * n_tok
        if cfg.ssm is None and not cfg.xlstm:
            base += 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.hd * seq * n_tok
    return base


def reconstruct_pair(f1: float, f2: float, n_layers: int) -> float:
    """total = f(1 layer) + (L-1) * (f(2 layers) - f(1 layer))."""
    body = max(f2 - f1, 0.0)
    return f1 + (n_layers - 1) * body
