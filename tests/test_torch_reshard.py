"""The elastic reshard of the port's checkpoints over four real ``gloo``
processes (a ``file://`` rendezvous), the counterpart of the reference's
``tests/test_checkpoint_data.py::test_elastic_reshard``.

Each process trains the reduced Phi-3.5-MoE one step of
:data:`golden.TRAIN_SPEC` over a (2, 2) ``("data", "model")`` mesh and
checkpoints it (the mesh's first rank writes the gathered leaves).  Then,
onto a (1, 4) and onto a (4, 1) mesh, it restores the checkpoint with
``shardings=`` (every leaf of the parameters and of the AdamW state comes
back bit for bit, split the new way) and lets ``train(mesh=)`` resume
from it: the resumed step's loss must meet the unsharded run's second
step within 1e-5 relative.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
METRIC_RTOL = 1e-5
RESHARDS = ((1, 4), (4, 1))
WORKER = r"""
import json, os, sys
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.bench import golden
from repro_torch.checkpoint.store import restore_checkpoint
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import device_mesh
from repro_torch.launch.train import train
from repro_torch.train.optimizer import AdamWState, adamw_init, tree_leaves

rank, tmp = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                        rank=rank, world_size=%(world)d)
spec = golden.TRAIN_SPEC
cfg = configs.get_arch(spec["arch"]).reduced()
params = params_from_numpy(golden.serve_params_numpy(cfg, 0), cfg, "cpu")
kw = dict(batch=spec["batch"], seq=spec["seq"], lr=spec["lr"],
          params=params, log_every=0)
ckpt = os.path.join(tmp, "ckpt")
out = {"first": train(spec["arch"], steps=1, mesh=device_mesh(2, 2, "cpu"),
                      ckpt_dir=ckpt, save_every=1, **kw).losses}
like = (params.tree(), adamw_init(params.tree()))
saved, step, _ = restore_checkpoint(ckpt, like, device="cpu")
for shape in %(reshards)r:
    mesh = device_mesh(*shape, "cpu")
    ps = shd.param_shardings(params, mesh)
    placed, _, _ = restore_checkpoint(
        ckpt, like, device="cpu",
        shardings=(ps, AdamWState(ps, ps, ps, None)))
    pairs = list(zip(tree_leaves(placed), tree_leaves(saved)))
    out[str(shape)] = dict(
        step=step,
        equal=all(torch.equal(dctx.whole(a), b) for a, b in pairs),
        split=sum(dctx.is_sharded(a) and a.to_local().numel() < a.numel()
                  for a, _ in pairs),
        losses=train(spec["arch"], steps=2, mesh=mesh, ckpt_dir=ckpt,
                     **kw).losses)
with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
""" % dict(world=WORLD, reshards=RESHARDS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("reshard"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), tmp],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def clean():
    spec = golden.TRAIN_SPEC
    cfg = configs.get_arch(spec["arch"]).reduced()
    params = params_from_numpy(golden.serve_params_numpy(cfg, 0), cfg, "cpu")
    return train(spec["arch"], steps=2, batch=spec["batch"], seq=spec["seq"],
                 lr=spec["lr"], params=params, device="cpu",
                 log_every=0).losses


def test_sharded_step_meets_the_unsharded_one(ranks, clean):
    for r in ranks:
        np.testing.assert_allclose(r["first"], clean[:1], rtol=METRIC_RTOL)


@pytest.mark.parametrize("shape", RESHARDS)
def test_restore_onto_another_mesh_gives_the_leaves_back(ranks, shape):
    for r in ranks:
        got = r[str(shape)]
        assert got["step"] == 1
        assert got["equal"]
        assert got["split"] > 0


@pytest.mark.parametrize("shape", RESHARDS)
def test_training_resumes_on_another_mesh(ranks, clean, shape):
    for r in ranks:
        np.testing.assert_allclose(r[str(shape)]["losses"], clean[1:],
                                   rtol=METRIC_RTOL)
