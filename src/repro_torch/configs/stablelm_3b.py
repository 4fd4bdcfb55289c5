"""StableLM-2 3B-class dense (MHA: kv == heads).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv=32, d_ff=6912,
    vocab=50304, head_dim=80, rope_theta=1e4,
)
