"""DeepSeek-V2-Lite (16B total): MLA (kv_lora 512) + 64 routed experts
top-6 + 2 shared experts. [arXiv:2405.04434; hf]"""
from repro_torch.models.config import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=102400, head_dim=128, rope_theta=1e4,
    mla=MLACfg(kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128),
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
               d_shared=1408),
)
