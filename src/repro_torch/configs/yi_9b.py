"""yi-9b [dense]: llama-arch GQA [arXiv:2403.04652; hf].

48L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_head=128,
        d_ff=11008, vocab=64000, act="swiglu", rope_theta=5000000.0)
