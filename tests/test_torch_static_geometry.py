"""The port's static meshes and ``is_idle`` against the reference on the
CPU: each mesh baked into the cycle (``traced_geometry=False``) equals its
lanes padded in one traced batch and the reference's run of that batch,
bit for bit; ``is_idle`` is one boolean over a whole state, equal to the
reference's before, during and after a run, with and without ``active``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import machine as ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import machine as port  # noqa: E402
from repro_torch.core.batch import stack_workloads  # noqa: E402
from test_torch_static import (CHUNK, KW, NAMES, SIZES, _same,  # noqa: E402,F401
                               lanes)


# ----------------------------------------------------------- the geometry --
def test_static_meshes_equal_padded_traced_lanes(lanes):
    """Each mesh baked into the cycle (2x2 and 4x4, fully static at nexus)
    equals its lane padded to 16 PEs in one traced batch of both sizes, and
    the reference's run of that batch, bit for bit."""
    pts = [(size, k) for size in SIZES for k in NAMES]
    traced = port.run_many(port.MachineConfig(**KW),
                           [lanes[s][0][k] for s, k in pts], chunk=CHUNK,
                           device="cpu")
    want = ref.run_many(ref.MachineConfig(**KW),
                        [lanes[s][1][k] for s, k in pts])
    _same(traced, want)
    for (w, h) in SIZES:
        static = port.MachineConfig(width=w, height=h, traced_modes=False,
                                    traced_geometry=False, **KW)
        got = port.run_many(static, [lanes[w, h][0][k] for k in NAMES],
                            chunk=CHUNK, device="cpu")
        _same(got, [r for (s, _), r in zip(pts, traced) if s == (w, h)])
        assert all(r.per_pe_busy.shape == (w * h,) for r in got)


# ---------------------------------------------------------------- is_idle --
def _stepped_batch(lanes, ticks):
    """spmv at 2x2 (padded to 16 PEs) and at 4x4 in one traced batch after
    ``ticks`` plain cycles: (state, active mask (B, N))."""
    wb = stack_workloads([lanes[2, 2][0]["spmv"], lanes[4, 4][0]["spmv"]])
    cfg = port.MachineConfig(**KW)
    st = port.init_state(cfg, wb.static_ams, wb.amq_len, wb.mem_val,
                         wb.mem_meta, device="cpu")
    cyc = port._make_cycle(cfg, wb.n_pes)
    prog, modes, geoms = (torch.as_tensor(np.asarray(a, np.int32)) for a in
                          (wb.prog, wb.modes if wb.modes is not None else
                           [port.mode_code(cfg)] * wb.batch, wb.geoms))
    for _ in range(ticks):
        st = cyc(prog, modes, geoms, st)
    pe = torch.arange(wb.n_pes)
    active = pe[None, :] < (geoms[:, 0] * geoms[:, 1])[:, None]
    return st, active


def _ref_state(st, b):
    leaves = convert.state_to_numpy(st)
    return ref.MachineState(**{k: jnp.asarray(v[b]) for k, v in
                               leaves.items()})


@pytest.mark.parametrize("ticks,idle", [(0, False), (6, False), (80, True),
                                        ("pad", True)])
def test_is_idle_matches_reference(lanes, ticks, idle):
    """Before, during and after the run, and after a flit is planted on a
    padded PE (work the ``active`` mask hides): each lane's ``is_idle``
    with and without ``active`` equals the reference's, and the batch's is
    the AND of its lanes'."""
    st, active = _stepped_batch(lanes, 80 if ticks == "pad" else ticks)
    if ticks == "pad":
        st.buf_n[0, 7, 2] = 1              # PE 7 is padding in lane 0
    per_lane = []
    for b in range(2):
        lane = port.MachineState(*(x[b] for x in st))
        for act in (None, active[b]):
            want = bool(ref.is_idle(_ref_state(st, b), None if act is None
                                    else jnp.asarray(act.numpy())))
            got = port.is_idle(lane, act)
            assert got.dtype == torch.bool and got.dim() == 0
            assert bool(got) == want, (b, act is not None)
        per_lane.append(bool(port.is_idle(lane)))
        assert bool(port.is_idle(lane, active[b])) == idle
    assert bool(port.is_idle(st)) == all(per_lane)
    assert bool(port.is_idle(st, active)) == idle
    if ticks == "pad":
        assert not bool(port.is_idle(st))
