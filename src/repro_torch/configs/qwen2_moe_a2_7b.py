"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L, d_model=2048, 16 heads (kv=16), d_expert=1408, vocab=151936.
"""
from ..models.config import ModelConfig
from ..models.moe import MoeCfg


def config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_head=128,
        d_ff=1408, vocab=151936,
        moe=MoeCfg(n_experts=60, top_k=4, d_expert=1408, n_shared=4,
                   n_groups=32),
        rope_theta=1000000.0)
