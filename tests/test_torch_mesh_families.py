"""Model parallelism for the transformer families beyond the dense and
MoE configs: MLA (the reduced DeepSeek-V2-Lite, with its MoE), the audio
encoder (HuBERT-XLarge) and the vision prefill (LLaVA-NeXT), each in f32
over a (2, 2) ``("data", "model")`` mesh of four CPU thread-ranks
(``tests/mesh_family_checks.py``).  Against the unsharded port on the
same inputs: the forward within 1e-5 (HuBERT through ``encode_step``,
LLaVA over its record's patches and tokens), the prefill and a decode
step over f32 caches and the caches themselves, ``serve_batch(mesh=)``'s
tokens, and two training steps within 1e-5 relative (``train(mesh=)`` for
DeepSeek, the training record's step for all three).  Against the
reference's records: HuBERT's and LLaVA's logits within
``golden.FAMILIES_TOL``, the served tokens, the training metrics within
``golden.TRAIN_RTOL``.  One run of four thread-ranks serves every test.
"""
import pytest

torch = pytest.importorskip("torch")

import mesh_family_checks as checks  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "hubert-xlarge", "llava-next-mistral-7b")
DECODERS = tuple(a for a in ARCHS if not checks.cfg_of(a).encoder_only)
#: leaves whose split the tests spell out: (local shape) over (2, 2), of
#: the reduced configs (d 128, 4 heads, vocab 512; MLA kv_lora 32, rope
#: 16, nope 32, v 32; cache 64 positions of 4 slots)
EXPECT = {
    "deepseek-v2-lite-16b": {
        "blocks/attn/wq": (64, 96), "blocks/attn/wukv": (32, 128),
        "blocks/attn/wdkv": (64, 48), "blocks/attn/wo": (64, 64),
        "blocks/moe/wi": (2, 64, 64),
        "blocks/ckv": (2, 2, 32, 32), "blocks/kr": (2, 2, 32, 16)},
    "hubert-xlarge": {
        "frontend/proj": (256, 64), "head/w": (64, 256),
        "blocks/mlp/wi": (64, 128), "blocks/mlp/wo": (128, 64)},
    "llava-next-mistral-7b": {
        "frontend/w1": (32, 64), "frontend/w2": (64, 64),
        "blocks/k": (2, 2, 2, 32, 32)},
}


@pytest.fixture(scope="module")
def legs():
    return checks.run(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_forward_matches_unsharded(legs, arch):
    checks.logits_match(legs, arch, "logits")


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b"])
def test_mesh_encode_and_vision_meet_the_record(legs, arch):
    kind = "encode" if arch == "hubert-xlarge" else "vision"
    rec = checks.golden.load_families_golden()[kind]
    for r in legs[1]:
        checks.golden.check_logits(r[arch]["logits"], rec)


@pytest.mark.parametrize("arch", DECODERS)
def test_mesh_prefill_and_decode_match_unsharded(legs, arch):
    """A prefill and one decode step over f32 caches placed by
    ``cache_specs``: the logits and every cache leaf after them (the
    latent cache written where each rank holds its sequence slice)."""
    checks.logits_match(legs, arch, "prefill")
    checks.logits_match(legs, arch, "decode")
    checks.caches_match(legs, arch)


@pytest.mark.parametrize("arch", DECODERS)
def test_mesh_serve_gives_the_unsharded_tokens(legs, arch):
    checks.served_match(legs, arch)


@pytest.mark.parametrize("arch", DECODERS)
def test_mesh_serve_meets_the_record(legs, arch):
    checks.served_meet_record(legs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_steps_match_unsharded(legs, arch):
    checks.metrics_match(legs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_meets_the_record(legs, arch):
    checks.train_meets_record(legs, arch)


def test_launch_train_on_the_mesh_matches_unsharded(legs):
    """``train(mesh=)`` itself (its token pipeline, placing and step) for
    the MLA + MoE config."""
    checks.metrics_match(legs, "deepseek-v2-lite-16b", "launch_train")


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_and_caches_follow_the_specs(legs, arch):
    checks.leaves_follow_specs(legs, arch, EXPECT[arch])


@pytest.mark.cuda
def test_cuda_mesh_families_reduced_legs():
    """On the card: ``chip_smoke.py``'s reduced ``[mesh]`` legs of these
    families (four thread-ranks on one card), which raise on a miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    stats = checks.cs.run_mesh_families_reduced("cuda", ARCHS)
    for arch in ARCHS:
        assert stats[arch]["logits_max_abs_err"] <= checks.LOGIT_ATOL
        assert stats[arch]["train_max_rel_err"] <= checks.METRIC_RTOL
