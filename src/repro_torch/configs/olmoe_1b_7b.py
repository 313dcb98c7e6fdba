"""olmoe-1b-7b [moe]: 64 experts, top-8 [arXiv:2409.02060; hf].

16L, d_model=2048, 16 heads (kv=16), d_expert=1024, vocab=50304, qk-norm.
"""
from ..models.config import ModelConfig
from ..models.moe import MoeCfg


def config() -> ModelConfig:
    return ModelConfig(
        arch="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_head=128,
        d_ff=1024, vocab=50304, qk_norm=True,
        moe=MoeCfg(n_experts=64, top_k=8, d_expert=1024, n_groups=32),
        rope_theta=10000.0)
