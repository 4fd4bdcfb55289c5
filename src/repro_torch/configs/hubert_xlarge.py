"""HuBERT-XLarge: encoder-only audio backbone (w2v2 arch); CNN frontend is a
stub (precomputed 512-d frame features). [arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, d_ff=5120,
    vocab=504, head_dim=80, encoder_only=True, frontend="audio",
)
