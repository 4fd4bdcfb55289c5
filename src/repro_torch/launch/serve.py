"""Batched serving launcher: prefill + greedy decode over a request batch.

The port of the reference's ``repro/launch/serve.py``.  Slot-based
continuous batching: each finished sequence's slot is refilled from the
pending queue (the new prompt is replayed through decode into the slot's
cache region), so the decode batch never idles.  The slot loop is the
reference's line for line: left padding of the first wave, the refill by
decode replay, one shared ``cache_index = slot_pos.max()`` per step and
the stop at ``cache_len - 1``.

    python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b
    python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.serve.steps import make_decode_step, make_prefill_step


@dataclasses.dataclass
class ServeResult:
    outputs: list            # list[np.ndarray] per request (generated ids)
    prefill_s: float
    decode_s: float
    tokens_generated: int

    @property
    def decode_tok_s(self) -> float:
        return self.tokens_generated / max(self.decode_s, 1e-9)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(arch: str | ArchConfig, requests: list[np.ndarray], *,
                max_new_tokens: int = 16, cache_len: int = 256,
                batch_slots: int = 4, device="cuda", reduced: bool = True,
                eos_id: int | None = None,
                params: lm.LM | None = None) -> ServeResult:
    """Generate ``max_new_tokens`` for every request (greedy).

    Deviations from the reference, each for running on one card:

    * ``device`` replaces ``mesh``: everything runs on that one device;
    * ``arch`` may also be an :class:`ArchConfig` (e.g. a depth-cut
      full-width config), to which ``reduced`` applies as to a name;
    * ``params`` serves given parameters (an :class:`lm.LM` on
      ``device``); by default they are ``lm.init_params`` in bf16 from
      a generator on ``device`` seeded with 0 (the reference draws its
      own from ``PRNGKey(0)``).
    """
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = configs.get_arch(configs.ALIASES.get(arch, arch))
    if reduced:
        cfg = cfg.reduced()
    assert not cfg.encoder_only, "encoder-only archs have no decode path"

    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm.init_params(cfg, gen)
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)

    pending = list(range(len(requests)))
    outputs: list[list[int]] = [[] for _ in requests]
    slot_req = [-1] * batch_slots            # request id per slot (-1 idle)
    slot_left = [0] * batch_slots
    slot_pos = np.zeros((batch_slots,), np.int32)

    def prompt_of(rid):
        p = np.asarray(requests[rid], np.int32)
        return p[-cache_len // 2:]           # clip over-long prompts

    t_pref = t_dec = 0.0
    gen_count = 0
    with torch.inference_mode():
        # initial fill: one shared prefill over the first wave, every
        # prompt right-aligned to the longest (left-padded with 0)
        wave = [pending.pop(0) for _ in range(min(batch_slots, len(pending)))]
        plen = max(len(prompt_of(r)) for r in wave) if wave else 1
        toks = np.zeros((batch_slots, plen), np.int32)
        for s, rid in enumerate(wave):
            p = prompt_of(rid)
            toks[s, plen - len(p):] = p
            slot_req[s] = rid
            slot_left[s] = max_new_tokens
        t0 = time.time()
        last_logits, caches = prefill(params, torch.as_tensor(toks,
                                                              device=device))
        nxt = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]
        _sync(device)
        t_pref += time.time() - t0
        slot_pos[:] = plen

        while any(r >= 0 for r in slot_req):
            t0 = time.time()
            nxt_host = nxt.cpu().numpy()
            # record the token just produced for live slots
            for s in range(batch_slots):
                rid = slot_req[s]
                if rid < 0 or slot_left[s] <= 0:
                    continue
                tok = int(nxt_host[s, 0])
                outputs[rid].append(tok)
                gen_count += 1
                slot_left[s] -= 1
                if slot_left[s] == 0 or (eos_id is not None and
                                         tok == eos_id):
                    # slot finished: refill from pending or retire
                    if pending:
                        # continuous batching: replay the new prompt
                        # through decode into this slot's cache region
                        rid2 = pending.pop(0)
                        slot_req[s] = rid2
                        slot_left[s] = max_new_tokens
                        p = prompt_of(rid2)
                        for tok2 in p[:-1]:
                            one = torch.zeros((batch_slots, 1),
                                              dtype=torch.int32,
                                              device=device)
                            one[s, 0] = int(tok2)
                            _, caches = decode(params, caches, one,
                                               int(slot_pos[s]))
                            slot_pos[s] += 1
                        nxt = nxt.clone()
                        nxt[s, 0] = int(p[-1])
                    else:
                        slot_req[s] = -1
            if not any(r >= 0 for r in slot_req):
                break
            nxt, caches = decode(params, caches, nxt, int(slot_pos.max()))
            _sync(device)
            slot_pos += 1
            t_dec += time.time() - t0
            if int(slot_pos.max()) >= cache_len - 1:
                break   # cache exhausted

    return ServeResult(
        outputs=[np.asarray(o, np.int32) for o in outputs],
        prefill_s=t_pref, decode_s=t_dec, tokens_generated=gen_count)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, 500, size=(args.prompt_len,))
            for _ in range(args.requests)]
    res = serve_batch(args.arch, reqs, max_new_tokens=args.max_new_tokens,
                      batch_slots=args.slots, device=args.device)
    print(f"served {len(reqs)} requests, {res.tokens_generated} tokens; "
          f"prefill {res.prefill_s:.2f}s decode {res.decode_s:.2f}s "
          f"({res.decode_tok_s:.1f} tok/s)")
    for i, o in enumerate(res.outputs):
        print(f"  req{i}: {o[:10]}...")


if __name__ == "__main__":
    main()
