"""The port's sharding rules (``repro_torch.distributed``) against the
reference's ``repro/distributed``, with no process group.

The specs read nothing of a mesh but its ordered axis name -> size map, so
both sides run on a stand-in with a ``shape`` map of the production
meshes: (16, 16) ``(data, model)`` and (2, 16, 16) ``(pod, data,
model)``.  For every one of the ten configs at full size:

* the parameters' specs equal the reference's leaf by leaf: the port's
  tree comes from its own ``lm.init_params`` under ``FakeTensorMode``
  (nothing allocated), the reference's from ``lm.shape_params``, and a
  port layer leaf's spec is the stacked leaf's without its leading
  ``None``;
* the caches' specs equal the reference's (both keep a leading layer
  axis), with ``long_context`` off at the decode cell's shape and on at
  the long cell's;
* ``batch_spec`` and ``batch_axes`` are the reference's.

``constrain``'s drop rule is held to the reference's own, whose
``with_sharding_constraint`` is caught before it reaches a device.
"""
import collections
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import context as ref_context  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import lm  # noqa: E402

MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


class StandIn:
    """A mesh that is only its ordered axis name -> size map, as both
    packages' spec functions read it."""

    def __init__(self, axes):
        self.shape = collections.OrderedDict(axes)
        self.mesh_dim_names = tuple(self.shape)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    with FakeTensorMode():
        return lm.init_params(configs.get_arch(arch),
                              torch.Generator(device="cpu")).tree()


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_lm.shape_params(ref_configs.get_arch(arch))


def _leaves_with_path(tree, path=()):
    """(path, leaf) pairs of a nested dict / list tree; list indices are
    part of the path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _ref_leaf(tree, path):
    """The reference's leaf for a port path: a layer index picks nothing
    (the reference stacks the layers)."""
    for k in path:
        if not isinstance(k, int):
            tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    m = StandIn(MESHES[mesh])
    port = shd.param_specs(_port_params(arch), m)
    ref = ref_sharding.param_specs(_ref_params(arch), m)
    seen = set()
    for path, spec in _leaves_with_path(port):
        stacked = any(isinstance(k, int) for k in path)
        want = tuple(_ref_leaf(ref, path))
        if stacked and want:
            assert want[0] is None, (path, want)
            want = want[1:]
        assert tuple(spec) == want, (path, spec, want)
        seen.add(tuple(k for k in path if not isinstance(k, int)))
    ref_paths = {tuple(k.key for k in kp) for kp, _ in
                 jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]}
    assert seen == ref_paths


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape_id", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, shape_id, mesh):
    seq, batch, _ = configs.SHAPES[shape_id]
    long_context = shape_id == "long_500k"
    m = StandIn(MESHES[mesh])
    cfg = configs.get_arch(arch)
    with FakeTensorMode():
        caches = lm.make_caches(cfg, batch, seq, device="cpu")
    ref_caches = jax.eval_shape(
        lambda: ref_lm.make_caches(ref_configs.get_arch(arch), batch, seq))
    port = dict(_leaves_with_path(
        shd.cache_specs(caches, m, long_context=long_context)))
    ref = dict(_leaves_with_path(jax.tree.map(
        tuple, ref_sharding.cache_specs(ref_caches, m,
                                        long_context=long_context))))
    assert sorted(port) == sorted(ref)
    for path, spec in port.items():
        assert tuple(spec) == ref[path], (path, spec, ref[path])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_equals_the_reference(mesh):
    m = StandIn(MESHES[mesh])
    assert shd.batch_axes(m) == ref_sharding.batch_axes(m)
    assert tuple(shd.batch_spec(m)) == tuple(ref_sharding.batch_spec(m))


def _ref_constrain(shape, axes, mesh):
    """The spec the reference's ``constrain`` hands to
    ``with_sharding_constraint`` on ``mesh``."""
    saved = (jax.sharding.NamedSharding, jax.lax.with_sharding_constraint,
             ref_context._MESH)
    jax.sharding.NamedSharding = lambda mesh, spec: spec
    jax.lax.with_sharding_constraint = lambda x, spec: spec
    try:
        with ref_context.use_mesh(mesh):
            return tuple(ref_context.constrain(
                np.zeros(shape, np.float32), *axes))
    finally:
        (jax.sharding.NamedSharding, jax.lax.with_sharding_constraint,
         ref_context._MESH) = saved


@pytest.mark.parametrize("shape,axes", [
    # (E, C, D) of the expert buffers: C = 6 does not divide 'data' (4)
    ((8, 6, 16), ("model", "data", None)),
    # a dim smaller than its axes' product (1 < 4), one that divides
    ((1, 8, 3), (("data", "model"), "model", None)),
    # an axis the mesh lacks ('pod') is dropped, the rest kept
    ((8, 12), (("pod", "data"), "model")),
])
def test_constrain_drop_rule_equals_the_reference(shape, axes):
    m = StandIn((("data", 4), ("model", 2)))
    want = _ref_constrain(shape, axes, m)
    assert tuple(dctx.fit_axes(axes, shape, m)) == want
    assert want != tuple(a if a is None else
                         (a if isinstance(a, tuple) else (a,)) for a in axes)


def test_constrain_is_the_identity_without_a_mesh_or_on_a_plain_tensor():
    x = torch.ones(4, 2)
    assert dctx.constrain(x, "data", None) is x
    with dctx.use_mesh(StandIn((("data", 2), ("model", 2)))):
        assert dctx.constrain(x, "data", None) is x
    assert dctx.get_mesh() is None


def test_placements_split_a_dim_over_both_axes_in_mesh_order():
    """A dim split over ``("data", "model")`` is ``Shard`` on both mesh
    dims (data major, the reference's order); an axis the mesh lacks
    leaves its mesh dim replicated."""
    m = StandIn((("data", 2), ("model", 2)))
    assert shd.placements(shd.P(("data", "model"), None), m) == (
        Shard(0), Shard(0))
    assert shd.placements(shd.P(None, "model"), m) == (Replicate(), Shard(1))
    assert shd.placements(shd.P(("pod", "data")), m) == (Shard(0),
                                                         Replicate())
    assert shd.placements(shd.P(), m) == (Replicate(), Replicate())
