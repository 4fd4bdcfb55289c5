"""Model parallelism on the port: the reduced Phi-3.5-MoE and a dense
config (Minitron-4B's GQA) over a (2, 2) ``("data", "model")`` mesh of
four CPU ranks, run as threads of this process in torch's ``threaded``
process group (``chip_smoke.thread_ranks``, which the card's ``[mesh]``
phase also uses).

Every rank places the same f32 parameters (``golden.serve_params_numpy``)
by ``param_shardings`` and runs, against the unsharded port on the same
inputs:

* ``lm.forward`` on a batch split over ``data``: logits within 1e-5
  (the row-parallel products sum over ``model`` in another order);
* ``serve_batch(mesh=)``: the same greedy tokens;
* two ``train(mesh=)`` steps of :data:`golden.TRAIN_SPEC` (and the dense
  config's with two microbatches): loss, aux loss and gradient norm
  within 1e-5 relative of the unsharded run, and the Phi run within
  ``golden.TRAIN_RTOL`` of ``train_reduced.json``.

One session of four ranks runs everything (DTensor's first call of each
op and placement is its slow one, so the tests share it).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.bench import golden  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import device_mesh  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import thread_ranks  # noqa: E402

ARCHS = {"moe": "phi35_moe_42b", "dense": "minitron_4b"}
LOGIT_ATOL = 1e-5
METRIC_RTOL = 1e-5
TRAIN = dict(golden.TRAIN_SPEC, steps=2)
#: five requests through four slots: one wave, then one refill replayed
#: through decode
SERVE = dict(max_new_tokens=3, batch_slots=4, cache_len=64)
N_REQUESTS = 5


def _cfg(arch):
    return configs.get_arch(arch).reduced()


def _params(arch):
    return params_from_numpy(golden.serve_params_numpy(_cfg(arch), 0),
                             _cfg(arch), "cpu")


def _tokens(arch):
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.integers(
        0, _cfg(arch).vocab, (TRAIN["batch"], TRAIN["seq"])).astype(np.int32))


def _train(arch, **kw):
    res = train(arch, steps=TRAIN["steps"], batch=TRAIN["batch"],
                seq=TRAIN["seq"], lr=TRAIN["lr"], params=_params(arch),
                log_every=0, **kw)
    return dict(loss=res.losses, aux_loss=res.aux_losses,
                grad_norm=res.grad_norms)


def _local_shapes(placed) -> dict:
    """(local, global) shape of the leaves whose splits the tests check."""
    blk = placed.blocks[0].tree()
    picks = {"embed": placed.embed.e, "unembed": placed.unembed.w,
             "wq": blk["attn"]["wq"], "attn_wo": blk["attn"]["wo"]}
    ffn = blk["moe"] if "moe" in blk else blk["mlp"]
    picks.update({f"ffn_{k}": ffn[k] for k in ("wi", "wg", "wo")})
    return {k: (tuple(v.to_local().shape), tuple(v.shape))
            for k, v in picks.items()}


def _rank(rank: int) -> dict:
    mesh = device_mesh(2, 2, "cpu")
    out = {}
    for key, arch in ARCHS.items():
        cfg, params = _cfg(arch), _params(arch)
        placed = shd.place_params(params, mesh)
        toks = _tokens(arch)
        toks = shd.place(toks, shd.batch_sharding(mesh, toks.shape))
        with torch.no_grad(), dctx.use_mesh(mesh):
            logits = dctx.whole(lm.forward(placed, cfg, {"tokens": toks})[0])
        served = serve_batch(arch, golden.serve_requests()[:N_REQUESTS],
                             mesh=mesh, params=params, **SERVE)
        out[key] = dict(
            logits=logits, local=_local_shapes(placed),
            served=[o.tolist() for o in served.outputs],
            train=_train(arch, mesh=mesh))
    out["micro"] = _train(ARCHS["dense"], mesh=mesh, microbatch=2)
    # the sequence-parallel residual stream between blocks
    cfg = dataclasses.replace(_cfg(ARCHS["moe"]), seq_shard_acts=True)
    toks = _tokens(ARCHS["moe"])
    toks = shd.place(toks, shd.batch_sharding(mesh, toks.shape))
    with torch.no_grad(), dctx.use_mesh(mesh):
        out["seq_logits"] = dctx.whole(lm.forward(
            shd.place_params(_params(ARCHS["moe"]), mesh), cfg,
            {"tokens": toks})[0])
    # constrain on a DTensor, and a dim split over both axes
    x = shd.place(torch.arange(48.).reshape(6, 8),
                  shd.named(shd.P(), mesh))
    y = shd.place(torch.arange(24.).reshape(3, 8),
                  shd.named(shd.P(), mesh))
    with dctx.use_mesh(mesh):
        out["constrain"] = (dctx.constrain(x, "data", "model").placements,
                            dctx.constrain(y, "data", "model").placements)
    both = shd.place(torch.arange(8.), shd.named(shd.P(("data", "model")),
                                                 mesh))
    out["both"] = (mesh.get_coordinate(), both.placements,
                   both.to_local().tolist())
    return out


@pytest.fixture(scope="module")
def ranks():
    return thread_ranks(_rank, 4)


@pytest.fixture(scope="module")
def unsharded():
    out = {}
    for key, arch in ARCHS.items():
        cfg, params = _cfg(arch), _params(arch)
        with torch.no_grad():
            logits = lm.forward(params, cfg, {"tokens": _tokens(arch)})[0]
        served = serve_batch(arch, golden.serve_requests()[:N_REQUESTS],
                             device="cpu", params=params, **SERVE)
        out[key] = dict(logits=logits,
                        served=[o.tolist() for o in served.outputs],
                        train=_train(arch, device="cpu"))
    out["micro"] = _train(ARCHS["dense"], device="cpu", microbatch=2)
    return out


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_mesh_forward_matches_unsharded(ranks, unsharded, key):
    want = unsharded[key]["logits"]
    for r in ranks:
        got = r[key]["logits"]
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= LOGIT_ATOL, err


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_mesh_serve_gives_the_unsharded_tokens(ranks, unsharded, key):
    want = unsharded[key]["served"]
    assert len(want) == N_REQUESTS
    assert all(len(o) == SERVE["max_new_tokens"] for o in want)
    for r in ranks:
        assert r[key]["served"] == want


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_mesh_train_steps_match_unsharded(ranks, unsharded, key):
    want = unsharded[key]["train"]
    for r in ranks:
        got = r[key]["train"]
        for k in ("loss", "aux_loss", "grad_norm"):
            assert len(got[k]) == TRAIN["steps"]
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       err_msg=k)


def test_sequence_parallel_forward_matches_unsharded(ranks, unsharded):
    """``seq_shard_acts``: the residual stream split over ``model`` along
    the sequence between blocks (the reference's ``_constrain_acts``)."""
    want = unsharded["moe"]["logits"]
    for r in ranks:
        err = (r["seq_logits"] - want).abs().max().item()
        assert err <= LOGIT_ATOL, err


def test_mesh_microbatched_steps_match_unsharded(ranks, unsharded):
    """Two microbatches a step: each chunk of the batch is split over
    ``data`` again, and the summed gradients keep their placements."""
    for r in ranks:
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(r["micro"][k], unsharded["micro"][k],
                                       rtol=METRIC_RTOL, err_msg=k)


def test_mesh_train_meets_the_golden_record(ranks):
    rec = golden.load_train_golden()
    want = {k: rec[k][:TRAIN["steps"]]
            for k in ("loss", "aux_loss", "grad_norm")}
    got = ranks[0]["moe"]["train"]
    golden.check_train(got["loss"], got["aux_loss"], got["grad_norm"], want)


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_weights_are_really_sharded(ranks, key):
    """Over (2, 2) the column- and row-parallel projections, the
    embeddings and the experts each hold a quarter of their elements on
    each rank at rest (split over both axes; the experts over ``model``,
    their ``d`` over ``data``, gathered only where they are used)."""
    for r in ranks:
        for name, (local, whole) in r[key]["local"].items():
            n, m = np.prod(local), np.prod(whole)
            assert n < m, name
            assert n * 4 == m, (name, local, whole)
    assert ranks[0]["moe"]["local"]["ffn_wi"] == ((2, 64, 64), (4, 128, 64))
    assert ranks[0]["moe"]["local"]["ffn_wo"] == ((2, 64, 64), (4, 64, 128))
    assert ranks[0]["dense"]["local"]["attn_wo"] == ((64, 64), (128, 128))


def test_constrain_redistributes_and_drops_what_does_not_fit(ranks):
    for r in ranks:
        fits, dropped = r["constrain"]
        assert fits == (Shard(0), Shard(1))
        assert dropped == (Replicate(), Shard(1))     # 3 rows over 2


def test_a_dim_split_over_both_axes_is_data_major(ranks):
    """``P(("data", "model"))`` of 8 elements puts chunk ``2 * data +
    model`` on rank ``(data, model)``: the reference's order."""
    seen = {}
    for coord, placements, local in (r["both"] for r in ranks):
        assert placements == (Shard(0), Shard(0))
        seen[tuple(coord)] = local
    k = lambda d, m: [2.0 * (2 * d + m), 2.0 * (2 * d + m) + 1]  # noqa: E731
    assert seen == {(d, m): k(d, m) for d in range(2) for m in range(2)}


@pytest.mark.cuda
def test_cuda_mesh_reduced_legs():
    """On the card: ``chip_smoke.py``'s reduced ``[mesh]`` legs (four
    thread-ranks on one card; the forward within 1e-5, the served tokens
    equal, two train steps within 1e-5 relative, the reshard bit for
    bit), which raise on a miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from chip_smoke import run_mesh_reduced
    stats = run_mesh_reduced("cuda")
    assert max(stats["logit_max_abs_err"].values()) <= LOGIT_ATOL
    assert max(stats["train_max_rel_err"].values()) <= METRIC_RTOL
    assert sorted(stats["served_tokens_equal"]) == sorted(ARCHS)
