"""The port's copy of the token data pipeline (``repro_torch.data``) against
the reference's ``repro.data``: the same batches byte for byte, the same
checkpointable ``state()`` and the same stream after ``restore()``."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import data as ref_data  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402

from repro_torch import data  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402


def _same_batches(a, b, n):
    for _ in range(n):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y) == ["labels", "tokens"]
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("vocab,batch,seq,seed,zipf_a", [
    (100, 4, 16, 3, 1.2), (512, 4, 32, 0, 1.2), (32064, 8, 128, 0, 1.2),
    (1000, 2, 8, 7, 1.5)])
def test_synthetic_stream_equals_reference(vocab, batch, seq, seed, zipf_a):
    _same_batches(data.SyntheticTokenStream(vocab, batch, seq, seed=seed,
                                            zipf_a=zipf_a),
                  ref_data.SyntheticTokenStream(vocab, batch, seq, seed=seed,
                                                zipf_a=zipf_a), 3)


def test_synthetic_state_and_restore_equal_reference():
    a = data.SyntheticTokenStream(100, 4, 16, seed=3)
    r = ref_data.SyntheticTokenStream(100, 4, 16, seed=3)
    for _ in range(5):
        next(a), next(r)
    assert a.state() == r.state() == {"kind": "synthetic", "seed": 3,
                                      "step": 5, "zipf_a": 1.2}
    b = data.SyntheticTokenStream(100, 4, 16)
    b.restore(r.state())
    _same_batches(b, r, 2)


def test_memmap_dataset_equals_reference(tmp_path):
    p = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(
        np.uint16).tofile(p)
    a = data.MemmapTokenDataset(str(p), batch=4, seq=32, seed=1)
    r = ref_data.MemmapTokenDataset(str(p), batch=4, seq=32, seed=1)
    _same_batches(a, r, 3)
    assert a.state() == r.state()
    b = data.MemmapTokenDataset(str(p), batch=4, seq=32)
    b.restore(r.state())
    _same_batches(b, r, 2)


def test_prefetcher_equals_reference_and_its_state_is_exact():
    pf = data.Prefetcher(data.SyntheticTokenStream(100, 2, 8, seed=7),
                         depth=2)
    r = ref_data.SyntheticTokenStream(100, 2, 8, seed=7)
    try:
        _same_batches(pf, r, 3)
        assert pf.state() == r.state()
    finally:
        pf.close()
    cont = data.SyntheticTokenStream(100, 2, 8)
    cont.restore(pf.state())
    _same_batches(cont, r, 2)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_make_pipeline_equals_reference(tmp_path, prefetch):
    cfg = get_arch("phi35_moe_42b").reduced()
    rcfg = ref_get_arch("phi35_moe_42b").reduced()
    a = data.make_pipeline(cfg, 4, 16, prefetch=prefetch)
    r = ref_data.make_pipeline(rcfg, 4, 16, prefetch=0)
    assert isinstance(a, data.Prefetcher) == bool(prefetch)
    try:
        _same_batches(a, r, 2)
        assert a.state() == r.state()
    finally:
        if prefetch:
            a.close()
    p = tmp_path / "tokens.bin"
    np.arange(3000, dtype=np.uint16).tofile(p)
    _same_batches(data.make_pipeline(cfg, 2, 8, path=str(p), prefetch=0),
                  ref_data.make_pipeline(rcfg, 2, 8, path=str(p),
                                         prefetch=0), 2)
