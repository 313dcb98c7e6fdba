"""internvl2-76b [vlm]: InternViT frontend (STUB per assignment) +
InternLM2-76B-style backbone [arXiv:2404.16821; unverified].

Backbone: 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=28672,
vocab=128256.  input_specs() supplies precomputed patch embeddings
(256 tokens) in place of the vision tower.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_head=128,
        d_ff=28672, vocab=128256, act="swiglu",
        rope_theta=1000000.0, n_patches=256)
