"""Model parallelism for the recurrent families: the Mamba-2 hybrid (the
reduced Zamba2-1.2B, with its shared attention block) and the xLSTM
(xLSTM-350M's mLSTM and sLSTM blocks), each in f32 over a (2, 2)
``("data", "model")`` mesh of four CPU thread-ranks
(``tests/mesh_family_checks.py``).  Against the unsharded port on the
same inputs: the forward within 1e-5 (Zamba2 also with the
sequence-parallel residual stream), the prefill and a decode step over
f32 caches and the recurrent states themselves, ``serve_batch(mesh=)``'s
tokens, and two training steps within 1e-5 relative (``train(mesh=)``
and the training record's step).  Against the reference's records: the
served tokens and the training metrics within ``golden.TRAIN_RTOL``.
One run of four thread-ranks serves every test.
"""
import pytest

torch = pytest.importorskip("torch")

import mesh_family_checks as checks  # noqa: E402

ARCHS = ("zamba2-1.2b", "xlstm-350m")
#: leaves whose split the tests spell out: (local shape) over (2, 2), of
#: the reduced configs (d 128, 4 heads; Mamba-2 di 256, 2 heads of 128,
#: d_state 16, conv 4; the mLSTM's di 256, 4 heads of 64; 4 slots)
EXPECT = {
    "zamba2-1.2b": {
        "mamba/mixer/win": (64, 289), "mamba/mixer/conv": (4, 128),
        "mamba/mixer/wout": (128, 64), "shared_attn/attn/wq": (64, 64),
        "mamba/h": (4, 2, 1, 128, 16), "mamba/conv": (4, 2, 3, 128),
        "shared_attn/k": (2, 2, 4, 32, 32)},
    "xlstm-350m": {
        "mlstm/mixer/wup": (64, 256), "mlstm/mixer/wqkv": (128, 384),
        "mlstm/mixer/wif": (128, 8), "mlstm/mixer/wdown": (128, 64),
        "slstm/mixer/wg": (64, 256), "slstm/mixer/wout": (64, 64),
        # the reference's cache_specs split the mLSTM state's first hp
        # (C's value index, n's key index) over model, not its heads
        "mlstm/c": (1, 2, 4, 32, 64), "mlstm/n": (1, 2, 4, 32),
        "slstm/c": (1, 2, 64)},
}


@pytest.fixture(scope="module")
def legs():
    return checks.run(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_forward_matches_unsharded(legs, arch):
    checks.logits_match(legs, arch, "logits")


def test_sequence_parallel_forward_matches_unsharded(legs):
    """Zamba2 with ``seq_shard_acts``: the residual stream split along the
    sequence over ``model`` after each Mamba-2 layer (the reference's
    ``_constrain_acts``), the scan regathering it."""
    checks.logits_match(legs, "zamba2-1.2b", "seq_logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_match_unsharded(legs, arch):
    """A prefill and one decode step over f32 caches placed by
    ``cache_specs``: the logits and every state after them (each
    layer's new state written into each rank's own shard)."""
    checks.logits_match(legs, arch, "prefill")
    checks.logits_match(legs, arch, "decode")
    checks.caches_match(legs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serve_gives_the_unsharded_tokens(legs, arch):
    checks.served_match(legs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serve_meets_the_record(legs, arch):
    checks.served_meet_record(legs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_steps_match_unsharded(legs, arch):
    checks.metrics_match(legs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_on_the_mesh_matches_unsharded(legs, arch):
    checks.metrics_match(legs, arch, "launch_train")


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_meets_the_record(legs, arch):
    checks.train_meets_record(legs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_and_caches_follow_the_specs(legs, arch):
    checks.leaves_follow_specs(legs, arch, EXPECT[arch])


@pytest.mark.cuda
def test_cuda_mesh_recurrent_reduced_legs():
    """On the card: ``chip_smoke.py``'s reduced ``[mesh]`` legs of these
    families (four thread-ranks on one card), which raise on a miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    stats = checks.cs.run_mesh_families_reduced("cuda", ARCHS)
    for arch in ARCHS:
        assert stats[arch]["logits_max_abs_err"] <= checks.LOGIT_ATOL
        assert stats[arch]["train_max_rel_err"] <= checks.METRIC_RTOL
