"""Stateless deterministic data pipeline.

Every batch is a pure function of (seed, step): a restart replays the
exact token stream with no iterator state to checkpoint.  Each sequence
tiles one pattern from a fixed seed-derived pool of 64 patterns of
period 17, with 10% of its tokens replaced by noise: structure that a
small model learns within a few hundred steps.

The reference draws from jax's threefry generator; this port builds the
same structure from ``torch.Generator`` streams on the host (the pool
from ``seed ^ 0x5EED``, the batch from a 64-bit mix of (seed, step)),
so the tokens differ from the reference's while their distribution is
the same.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device

_MASK64 = (1 << 64) - 1
PATTERN_PERIOD = 17     # structure the model can learn
PATTERN_POOL = 64       # fixed pool of patterns (memorizable)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = device

    def batch(self, step: int) -> dict:
        return batch_for_step(self.cfg, step, self.device)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def _stream_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step) (splitmix64's finalizer
    over the pair), so neighbouring steps draw unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def batch_for_step(cfg: DataConfig, step: int, device=None) -> dict:
    """(seed, step) -> {"tokens": (B, S) int32} on ``device`` (``None``:
    the card); pure and deterministic.

    Each sequence tiles one pattern from a fixed seed-derived pool, with
    10% corruption: the model must identify the pattern from the prefix
    and predict the rest.
    """
    dev = resolve_device(device)
    b, s = cfg.global_batch, cfg.seq_len
    pool = torch.randint(
        0, cfg.vocab, (PATTERN_POOL, PATTERN_PERIOD),
        generator=torch.Generator().manual_seed(cfg.seed ^ 0x5EED),
        dtype=torch.int32)
    gen = torch.Generator().manual_seed(_stream_seed(cfg.seed, step))
    ids = torch.randint(0, PATTERN_POOL, (b,), generator=gen)
    reps = -(-s // PATTERN_PERIOD)
    tokens = pool[ids].repeat(1, reps)[:, :s]
    noise_mask = torch.rand((b, s), generator=gen) < 0.1
    noise = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                          dtype=torch.int32)
    tokens = torch.where(noise_mask, noise, tokens)
    return {"tokens": tokens.to(dev)}


def host_shard(batch: dict, host_index: int, n_hosts: int) -> dict:
    """Per-host slice of the global batch (multi-host data loading)."""
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_index * per:(host_index + 1) * per]
    return {k: slc(v) for k, v in batch.items()}
