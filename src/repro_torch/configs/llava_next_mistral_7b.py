"""LLaVA-NeXT (Mistral-7B backbone) with anyres tiling; CLIP tower is a stub
(precomputed 1024-d patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=32000, head_dim=128, rope_theta=1e6, frontend="vision",
    n_patches=2880, d_frontend=1024,
)
