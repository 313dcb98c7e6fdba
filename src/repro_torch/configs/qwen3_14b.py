"""qwen3-14b [dense]: qk_norm + GQA [hf:Qwen/Qwen3-8B; hf].

40L, d_model=5120, 40 heads (GQA kv=8, head_dim=128), d_ff=17408,
vocab=151936, per-head RMS qk-norm, SwiGLU.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv=8, d_head=128,
        d_ff=17408, vocab=151936, act="swiglu", qk_norm=True,
        rope_theta=1000000.0)
