"""Checks shared by ``tests/test_torch_mesh_families.py`` and
``tests/test_torch_mesh_recurrent.py``: reduced families over a (2, 2)
``("data", "model")`` mesh of four CPU ranks run as threads of one
process (``chip_smoke.thread_ranks``), every rank held to the unsharded
port on the same inputs and rank 0 to the reference's records.

:func:`run` gives, for each arch, the unsharded run and each rank's run
of ``chip_smoke.mesh_family_leg`` (forward, prefill and one decode step
over f32 caches, ``serve_batch`` at the record's traffic, two steps of
the training record), and for the archs that take ``train()``'s token stream
also two ``train()`` steps of ``golden.TRAIN_SPEC``'s traffic.
"""
import math
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.bench import golden
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import device_mesh
from repro_torch.launch.train import train
from repro_torch.models import lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

LOGIT_ATOL = cs.MESH_LOGIT_ATOL
METRIC_RTOL = cs.MESH_METRIC_RTOL
METRICS = ("loss", "aux_loss", "grad_norm")
SIZES = {"data": 2, "model": 2}


class StandIn:
    """A (2, 2) mesh as far as the spec functions read one (no ranks)."""
    shape = SIZES
    mesh_dim_names = tuple(SIZES)


def cfg_of(arch):
    return configs.get_arch(configs.ALIASES[arch]).reduced()


def takes_token_stream(arch) -> bool:
    """Whether ``train()``'s token pipeline can feed ``arch`` (not the
    frontend families)."""
    return cfg_of(arch).frontend == "none"


def _launch_train(arch, **kw) -> dict:
    spec = golden.TRAIN_SPEC
    cfg = cfg_of(arch)
    params = params_from_numpy(golden.serve_params_numpy(cfg, 0), cfg, "cpu")
    res = train(arch, steps=2, batch=spec["batch"], seq=spec["seq"],
                lr=spec["lr"], params=params, log_every=0, **kw)
    return dict(loss=res.losses, aux_loss=res.aux_losses,
                grad_norm=res.grad_norms)


def run(archs) -> tuple[dict, list]:
    """(the unsharded legs, each rank's legs) of ``archs``."""
    want = {}
    for a in archs:
        want[a] = cs.mesh_family_leg(a, "cpu")
        if takes_token_stream(a):
            want[a]["launch_train"] = _launch_train(a, device="cpu")

    def rank(r):
        mesh = device_mesh(2, 2, "cpu")
        out = {}
        for a in archs:
            out[a] = cs.mesh_family_leg(a, "cpu", mesh)
            if takes_token_stream(a):
                out[a]["launch_train"] = _launch_train(a, mesh=mesh)
        return out

    return want, cs.thread_ranks(rank, 4)


def logits_match(legs, arch, key):
    want, runs = legs
    w = want[arch][key]
    for r in runs:
        got = r[arch][key]
        assert got.shape == w.shape and torch.isfinite(got).all()
        err = (got - w).abs().max().item()
        assert err <= LOGIT_ATOL, (key, err)


def caches_match(legs, arch):
    want, runs = legs
    for r in runs:
        assert cs.cache_err(r[arch]["caches"], want[arch]["caches"]) <= \
            LOGIT_ATOL


def served_match(legs, arch):
    want, runs = legs
    w = want[arch]["served"]
    assert len(w) == len(golden.serve_requests())
    for r in runs:
        assert r[arch]["served"] == w


def served_meet_record(legs, arch):
    rec = golden.load_families_golden()["serve"][arch]
    for r in legs[1]:
        assert golden.check_serve_tokens(r[arch]["served"], rec) > 0


def metrics_match(legs, arch, key="train"):
    want, runs = legs
    w = want[arch][key]
    for r in runs:
        for k in METRICS:
            assert len(r[arch][key][k]) == 2
            np.testing.assert_allclose(r[arch][key][k], w[k],
                                       rtol=METRIC_RTOL, err_msg=k)


def train_meets_record(legs, arch):
    rec = golden.load_train_families_golden()["archs"][arch]
    got = legs[1][0][arch]["train"]
    golden.check_train(*(got[k] for k in METRICS),
                       {k: rec[k][:len(got[k])] for k in METRICS})


def _local_shape(shape, spec) -> tuple:
    """``shape`` split by ``spec`` over :data:`SIZES`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(SIZES[a] for a in (
        ax if isinstance(ax, tuple) else (ax,))) if ax else d
        for d, ax in zip(shape, spec))


def leaves_follow_specs(legs, arch, expect: dict):
    """Every rank's sharded parameter and cache leaves hold the slice the
    reference's specs give them (``param_specs``, ``cache_specs``), every
    leaf the specs split is split, and the leaves of ``expect`` (path ->
    local shape) have those local shapes."""
    cfg = cfg_of(arch)
    params = params_from_numpy(golden.serve_params_numpy(cfg, 0), cfg, "cpu")
    specs = cs.first_layer_leaves(shd.param_specs(params, StandIn()))
    if not cfg.encoder_only:
        caches = lm.make_caches(cfg, 4, cs.MESH_REDUCED_SERVE["cache_len"],
                                dtype=torch.float32, device="cpu")
        specs.update(cs.first_layer_leaves(shd.cache_specs(caches,
                                                            StandIn())))
    split = {k for k, s in specs.items() if any(ax for ax in s)}
    for r in legs[1]:
        shapes = dict(r[arch]["params"], **r[arch].get("cache_shapes", {}))
        assert split <= set(shapes), sorted(split - set(shapes))
        for path, (local, whole) in shapes.items():
            assert local == _local_shape(whole, specs[path]), path
        for path, local in expect.items():
            assert shapes[path][0] == local, (path, shapes[path])
