"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81 Mamba2 layers, d_model=3584, shared attention (32 heads, kv=32,
d_head=112) applied every 6 layers with per-invocation LoRA (rank 128),
ssm_state=64.  Sub-quadratic decode => long_500k supported.
"""
from ..models.config import ModelConfig, SsmCfg


def config() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_head=112,
        d_ff=14336, vocab=32000, act="swiglu",
        ssm=SsmCfg(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        attn_every=6, lora_rank=128, tie_embeddings=True,
        rope_theta=10000.0, supports_long_context=True,
        block_q=512, block_k=1024)
