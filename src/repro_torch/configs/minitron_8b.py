"""Minitron-8B (pruned Nemotron-4). [arXiv:2407.14679; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=16384,
    vocab=256000, head_dim=128, rope_theta=1e4,
)
