"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's: the same round trip, retention, torn-write, async and
structure checks as ``tests/test_checkpoint_data.py``, plus a restore
onto a named device, a bfloat16 leaf stored without ``ml_dtypes``, and
checkpoints written by either package restored by the other with equal
bits."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import store as ref_store  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, list_steps,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core.machine import MachineState  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 16), generator=g),
            "b": {"x": torch.arange(5, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _leaves_equal(a[k], b[k])
        else:
            assert torch.as_tensor(a[k]).dtype == b[k].dtype, k
            assert torch.equal(torch.as_tensor(a[k]), b[k].cpu()), k


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t, extra={"data": {"step": 9}})
    got, step, extra = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 3 and extra["data"]["step"] == 9
    _leaves_equal(t, got)


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.latest() == 4
    # only the 2 newest survive
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000003", "step_00000004"]
    assert list_steps(str(tmp_path)) == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    # a torn write: directory exists but no commit marker
    torn = tmp_path / "step_00000002"
    torn.mkdir()
    (torn / "tree.json").write_text("{}")
    assert latest_step(str(tmp_path)) == 1
    _, step, _ = restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 1
    with pytest.raises(FileNotFoundError, match="incomplete"):
        restore_checkpoint(str(tmp_path), t, step=2, device="cpu")


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    mgr.save(5, t, blocking=False)
    mgr.wait()
    got, step, _ = mgr.restore(t, device="cpu")
    assert step == 5
    _leaves_equal(t, got)


def test_async_save_snapshot_isolated(tmp_path):
    """Updating the source tree in place after save() must not reach the
    file: a numpy array, a CPU tensor (whose .numpy() is a view) and a
    MachineState leaf the engine would update in place."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    arr = np.ones((4,), np.float32)
    ten = torch.ones((4,), dtype=torch.int32)
    mgr.save(1, {"a": arr, "t": ten}, blocking=False)
    arr *= 100.0
    ten.mul_(100)
    mgr.wait()
    got, _, _ = mgr.restore({"a": arr, "t": ten}, device="cpu")
    np.testing.assert_array_equal(got["a"].numpy(), np.ones((4,)))
    assert torch.equal(got["t"], torch.ones((4,), dtype=torch.int32))


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"only": torch.zeros((2,))},
                           device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), dict(_tree(),
                                               w=torch.zeros((2, 2))),
                           device="cpu")


def test_restore_onto_named_device(tmp_path):
    """``device=`` takes the reference's ``shardings=`` place: every
    leaf comes back on that device, numpy leaves included."""
    t = dict(_tree(), host=np.arange(6, dtype=np.int64).reshape(2, 3))
    save_checkpoint(str(tmp_path), 1, t)
    got, _, _ = restore_checkpoint(str(tmp_path), t,
                                   device=torch.device("cpu"))
    for k in ("w", "step", "host"):
        assert got[k].device == torch.device("cpu"), k
    assert got["b"]["x"].device == torch.device("cpu")
    assert torch.equal(got["host"], torch.as_tensor(t["host"]))


def test_bfloat16_leaf_without_ml_dtypes(tmp_path):
    """A bf16 tensor is stored as its raw uint16 bits with ``ml_dtype:
    bfloat16`` in tree.json (the reference's encoding) and restored by
    viewing the bits back, bit for bit."""
    import json
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"x": x})
    d = tmp_path / "step_00000001"
    meta = json.loads((d / "tree.json").read_text())
    assert meta["leaves"][0]["ml_dtype"] == "bfloat16"
    raw = np.load(d / "leaf_00000.npy")
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(raw.view(np.int16),
                                  x.view(torch.int16).numpy())
    got, _, _ = restore_checkpoint(str(tmp_path), {"x": x}, device="cpu")
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def _state(rng):
    """A MachineState of random int32/bool leaves (one lane, 4 PEs)."""
    shapes = dict(buf=(1, 4, 5, 3, 6), buf_n=(1, 4, 5), amq=(1, 4, 7, 6),
                  pend=(1, 4, 9, 6), mem_val=(1, 4, 8),
                  mem_meta=(1, 4, 8, 2), stream_msg=(1, 4, 6),
                  swq=(1, 4, 5, 6), st_stall=(1, 4, 5))
    out = {}
    for k in MachineState._fields:
        shp = shapes.get(k, (1, 4))
        if k == "stream_on":
            out[k] = rng.integers(0, 2, size=shp).astype(bool)
        else:
            out[k] = rng.integers(-50, 50, size=shp).astype(np.int32)
    return out


def test_cross_package_checkpoints(tmp_path):
    """A tree saved by either package restores in the other with equal
    bits: a MachineState (NamedTuple, field order) beside dict keys that
    sort differently from their insertion order, a list and a bf16 leaf —
    the leaf order is the reference's tree flatten order."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro.core.machine import MachineState as RefState
    rng = np.random.default_rng(3)
    leaves = _state(rng)
    half = rng.standard_normal((2, 3)).astype(np.float32)
    tree_ref = {"z": np.arange(3, dtype=np.int32),
                "st": RefState(**{k: jnp.asarray(v)
                                  for k, v in leaves.items()}),
                "a": [np.int32(4), jnp.asarray(half).astype(jnp.bfloat16)]}
    tree_port = {"z": torch.arange(3, dtype=torch.int32),
                 "st": MachineState(**{k: torch.tensor(v)
                                       for k, v in leaves.items()}),
                 "a": [torch.tensor(4, dtype=torch.int32),
                       torch.tensor(half).to(torch.bfloat16)]}
    # reference -> port
    ref_store.save_checkpoint(str(tmp_path / "ref"), 2, tree_ref,
                              extra={"who": "ref"})
    got, step, extra = restore_checkpoint(str(tmp_path / "ref"), tree_port,
                                          device="cpu")
    assert step == 2 and extra == {"who": "ref"}
    assert isinstance(got["st"], MachineState)
    for k in MachineState._fields:
        assert torch.equal(got["st"][MachineState._fields.index(k)],
                           tree_port["st"]._asdict()[k]), k
    assert torch.equal(got["z"], tree_port["z"])
    assert int(got["a"][0]) == 4
    assert got["a"][1].dtype == torch.bfloat16
    assert torch.equal(got["a"][1].view(torch.int16),
                       tree_port["a"][1].view(torch.int16))
    # port -> reference
    save_checkpoint(str(tmp_path / "port"), 5, tree_port,
                    extra={"who": "port"})
    back, step, extra = ref_store.restore_checkpoint(
        str(tmp_path / "port"), tree_ref)
    assert step == 5 and extra == {"who": "port"}
    for k in RefState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back["st"], k)),
                                      leaves[k], err_msg=k)
        assert np.asarray(getattr(back["st"], k)).dtype == leaves[k].dtype
    np.testing.assert_array_equal(np.asarray(back["z"]), np.arange(3))
    bf = np.asarray(back["a"][1])
    assert bf.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        bf.view(np.uint16),
        np.asarray(tree_ref["a"][1]).view(np.uint16))
