"""Zamba2-1.2B: Mamba-2 backbone + shared attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32000, head_dim=64,
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, n_heads=32, chunk=128,
               attn_every=6),
)
