"""nemotron-4-340b [dense]: GQA + squared-ReLU MLP
[arXiv:2402.16819; unverified].

96L, d_model=18432, 96 heads (GQA kv=8, head_dim=192), d_ff=73728
(non-gated squared-ReLU), vocab=256000.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv=8, d_head=192,
        d_ff=73728, vocab=256000, act="sqrelu", rope_theta=10000.0)
