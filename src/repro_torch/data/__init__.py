"""Synthetic, stateless training data: a batch is a pure function of
(seed, step)."""
from .synthetic import DataConfig, SyntheticLM, batch_for_step, host_shard

__all__ = ["DataConfig", "SyntheticLM", "batch_for_step", "host_shard"]
