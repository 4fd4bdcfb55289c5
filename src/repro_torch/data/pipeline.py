"""Token data pipeline: synthetic + memmap sources, checkpointable state,
background prefetch (DESIGN.md §3/§5).

Both sources are *stateful iterators* with an explicit, JSON-able
``state()`` — the checkpoint stores it, so a restarted (or re-scaled) job
resumes the exact stream position.  Determinism: batch ``i`` of a given
(seed, batch, seq) configuration is identical across restarts and across
data-parallel re-sharding, because indices are derived from a counter, not
from consumed-iterator state.

A copy of the reference's ``repro/data/pipeline.py`` (numpy only, no
JAX); ``tests/test_torch_data.py`` holds its batches and states equal to
the reference's, byte for byte.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticTokenStream:
    """Deterministic synthetic LM batches (counter-indexed Philox draws).

    Tokens are Zipf-distributed (natural-language-like unigram skew), so the
    stream is *learnable*: cross-entropy falls from ln(V) toward the Zipf
    entropy as the model fits the unigram (and the loss curve in the e2e
    example actually moves).
    """

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int = 0,
                 start_step: int = 0, zipf_a: float = 1.2):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.step = start_step
        self.zipf_a = zipf_a
        w = 1.0 / np.arange(1, vocab + 1) ** zipf_a
        self._p = w / w.sum()

    def state(self) -> dict:
        return {"kind": "synthetic", "seed": self.seed, "step": self.step,
                "zipf_a": self.zipf_a}

    def restore(self, st: dict):
        assert st["kind"] == "synthetic"
        self.seed, self.step = st["seed"], st["step"]

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng([self.seed, self.step])
        toks = rng.choice(self.vocab, size=(self.batch, self.seq),
                          p=self._p).astype(np.int32)
        self.step += 1
        return {"tokens": toks, "labels": toks}


class MemmapTokenDataset:
    """Flat binary token file -> fixed-length LM batches.

    The file is a contiguous array of token ids (uint16 or int32).  Each
    batch draws ``batch`` random windows of ``seq+1`` tokens (input/label
    shift), seeded by (seed, step) so restarts are exact.
    """

    def __init__(self, path: str, batch: int, seq: int, *,
                 dtype=np.uint16, seed: int = 0, start_step: int = 0):
        self.path = path
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        assert self.tokens.size > seq + 1, "token file too small"
        self.batch, self.seq = batch, seq
        self.seed, self.step = seed, start_step

    def state(self) -> dict:
        return {"kind": "memmap", "path": self.path, "seed": self.seed,
                "step": self.step}

    def restore(self, st: dict):
        assert st["kind"] == "memmap"
        self.seed, self.step = st["seed"], st["step"]

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng([self.seed, self.step])
        starts = rng.integers(0, self.tokens.size - self.seq - 1,
                              (self.batch,))
        win = np.stack([np.asarray(self.tokens[s:s + self.seq + 1])
                        for s in starts]).astype(np.int32)
        self.step += 1
        return {"tokens": win[:, :-1], "labels": win[:, 1:]}


class Prefetcher:
    """Background-thread prefetch queue over any batch iterator.

    Keeps ``depth`` host batches ready so the accelerator never waits on
    batch assembly.  ``state()`` forwards the *source* state adjusted for
    in-flight batches, so checkpoints are exact despite the lookahead.
    """

    def __init__(self, source, *, depth: int = 2):
        self.source = source
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._served = 0
        # the source runs ahead (queued + one in-flight blocked on put), so
        # checkpoint state is derived from the *served* count against the
        # state captured before the thread starts — exact by construction
        # for the counter-indexed sources.
        self._base_state = dict(source.state())
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised on get
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        self._served += 1
        return item

    def state(self) -> dict:
        st = dict(self._base_state)
        st["step"] = st["step"] + self._served
        return st

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def make_pipeline(cfg, batch: int, seq: int, *, path: str | None = None,
                  seed: int = 0, prefetch: int = 2):
    """Build the standard pipeline for an arch config."""
    if path:
        src = MemmapTokenDataset(path, batch, seq, seed=seed)
    else:
        src = SyntheticTokenStream(cfg.vocab, batch, seq, seed=seed)
    return Prefetcher(src, depth=prefetch) if prefetch else src
