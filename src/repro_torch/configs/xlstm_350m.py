"""xLSTM-350M: sLSTM + mLSTM blocks, no separate FFN (d_ff = 0).
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304, head_dim=256, xlstm=True,
)
