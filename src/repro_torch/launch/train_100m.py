"""End-to-end example: train a ~100M-parameter LM for a few hundred steps
with checkpoint/restart fault tolerance; the port of the reference's
``examples/train_100m.py``.

The model is a scaled member of the stablelm family (dense decoder, GQA):
d_model=640, 10 layers, 32k vocab, about 104M parameters
(:data:`CFG_100M`, the reference's field for field).  It trains through
:func:`repro_torch.launch.train.train` on the card (``--device`` names
another device); a checkpoint is written every ``--save-every`` steps and
the run is resumable (rerun the same command after a kill).  The loss
curve and throughput are printed.

    python -m repro_torch.launch.train_100m --steps 200
    # quick smoke: --steps 20 --batch 2 --seq 64
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import TrainLoopResult, train
from repro_torch.models.config import ArchConfig

CFG_100M = ArchConfig(
    name="repro-100m", family="dense",
    n_layers=10, d_model=640, n_heads=10, n_kv=5, d_ff=2560,
    vocab=32768, head_dim=64, rope_theta=1e4, remat="none",
)


def tokens_per_s(res: TrainLoopResult, tokens_per_step: int) -> float:
    """Tokens per second over the run's steps after the first (which
    pays the one-time set-up)."""
    steady = res.step_s[1:] or res.step_s
    return tokens_per_step * len(steady) / sum(steady)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = CFG_100M
    n_params = cfg.param_count()
    tok_per_step = args.batch * args.seq
    print(f"model: {cfg.name}  params≈{n_params/1e6:.0f}M  "
          f"tokens/step={tok_per_step}")
    res = train(cfg, reduced=False, steps=args.steps, batch=args.batch,
                seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                save_every=args.save_every, device=args.device, log_every=10)
    tps = tokens_per_s(res, tok_per_step) if res.step_s else float("nan")
    print(f"\ndone: {len(res.losses)} steps in {sum(res.step_s):.0f}s, "
          f"final loss {res.final_loss:.4f}, {tps:,.0f} tok/s "
          f"({6 * n_params * tps / 1e9:.1f} GFLOP/s)")


if __name__ == "__main__":
    main()
