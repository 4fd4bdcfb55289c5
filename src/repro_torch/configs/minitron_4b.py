"""Minitron-4B (pruned Nemotron-4). [arXiv:2407.14679; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=9216,
    vocab=256000, head_dim=128, rope_theta=1e4,
)
