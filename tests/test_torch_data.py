"""The port's synthetic data (``repro_torch.data``).

The reference draws its batches from jax's threefry generator; the port
builds the same structure from ``torch.Generator`` streams, so the tokens
differ (ROADMAP Queue 3).  Held here: ``batch_for_step`` is a pure
function of (seed, step), int32 (B, S) below the vocabulary; each row
tiles one pattern of a seed-derived pool of 64 patterns of period 17,
about 10% of its tokens replaced by noise, the pool the same at every
step; the reference's batches show the same structure under the same
check; ``host_shard`` partitions a batch; ``SyntheticLM`` iterates the
steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batch_for_step as jbatch_for_step
from repro_torch.data import (DataConfig, SyntheticLM, batch_for_step,
                              host_shard)

CFG = dict(vocab=5000, seq_len=340, global_batch=64, seed=3)


def _tokens(step, **kw):
    return batch_for_step(DataConfig(**(CFG | kw)), step, "cpu")["tokens"]


def _structure(tokens: np.ndarray, period: int):
    """Per row, the pattern it tiles (the most common token at each
    phase of the period) and the share of positions that hold it."""
    b, s = tokens.shape
    reps = -(-s // period)
    padded = np.full((b, reps * period), -1, np.int64)
    padded[:, :s] = tokens
    by_phase = padded.reshape(b, reps, period)
    patterns, kept = [], []
    for row in by_phase:
        pat = [np.bincount(col[col >= 0]).argmax() for col in row.T]
        patterns.append(tuple(pat))
        kept.append(np.mean(row[row >= 0].reshape(-1) ==
                            np.tile(pat, reps)[:s]))
    return patterns, np.asarray(kept)


def test_pure_in_seed_and_step():
    a, b = _tokens(7), _tokens(7)
    assert a.dtype == torch.int32 and a.shape == (64, 340)
    assert torch.equal(a, b)
    assert not torch.equal(a, _tokens(8))
    assert not torch.equal(a, _tokens(7, seed=4))
    assert int(a.min()) >= 0 and int(a.max()) < CFG["vocab"]


@pytest.mark.parametrize("source", ["port", "reference"])
def test_pattern_structure(source):
    """Each row tiles one of at most 64 patterns of period 17 with about
    10% noise; the pool is a function of the seed alone."""
    def draw(step):
        if source == "port":
            return _tokens(step).numpy()
        return np.asarray(jbatch_for_step(JDataConfig(**CFG), step)
                          ["tokens"])
    pools = []
    for step in (0, 1):
        tokens = draw(step)
        patterns, kept = _structure(tokens, 17)
        # the noise: 10% of 64 x 340 tokens, each kept position a pattern
        # token (a noise token equal to it by chance is 1 in 5,000)
        assert 0.87 < kept.mean() < 0.93
        assert kept.min() > 0.75
        pools.append(set(patterns))
    assert len(pools[0] | pools[1]) <= 64
    assert pools[0] & pools[1]            # one pool across steps


def test_host_shard_partitions_batch():
    b = batch_for_step(DataConfig(vocab=100, seq_len=8, global_batch=8),
                       0, "cpu")
    parts = [host_shard(b, i, 4)["tokens"] for i in range(4)]
    assert all(p.shape == (2, 8) for p in parts)
    assert torch.equal(torch.cat(parts), b["tokens"])


def test_synthetic_lm_iterates_steps():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=2, seed=1)
    it = iter(SyntheticLM(cfg, device="cpu"))
    for step in range(3):
        assert torch.equal(next(it)["tokens"],
                           batch_for_step(cfg, step, "cpu")["tokens"])


def test_device_none_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: device=None runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_for_step(DataConfig(vocab=10, seq_len=4, global_batch=1), 0)


def test_same_shape_and_range_as_reference():
    jt = jbatch_for_step(JDataConfig(**CFG), 5)["tokens"]
    t = _tokens(5)
    assert jt.dtype == jnp.int32 and tuple(jt.shape) == tuple(t.shape)
    assert int(jnp.max(jt)) < CFG["vocab"]
