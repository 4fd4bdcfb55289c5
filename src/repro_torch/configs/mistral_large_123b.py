"""Mistral-Large-Instruct-2407 (123B dense).
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_ff=28672,
    vocab=32768, head_dim=128, rope_theta=1e6,
)
