"""The port's Whisper (encoder-decoder with cross-attention) against
``repro``'s, on the CPU.

Reduced whisper-tiny (two encoder and two decoder layers, 16 frames per
clip, in the run's dtype): prefill, one decode step and the loss against
the reference, greedy ``generate`` against the reference's
``ServeEngine``, the port's decode against its own prefill, the encoder
on the blockwise path (non-causal, ragged tiles) against the
reference's dense one, the cross K/V cache, and the decoder positions'
clamp near ``max_seq``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import whisper as jwh
from repro_torch.configs import get_config
from repro_torch.models import common as tcommon, make_arch
from repro_torch.models import whisper as twh
from repro_torch.serve import ServeEngine

from _lm_reference import (ATOL, BF16_ATOL, CTX, FRAMES, JCTX, as_jax,
                           as_torch, inputs, max_err, model_gaps, pair,
                           reference_generate, run_reference, tokens_held)
from _serve_reference import jserve  # noqa: F401

ARCH = "whisper-tiny"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_decode_and_loss_match_reference(dtype):
    """Largest gaps seen at these inputs: f32 prefill 5.0e-6, decode
    3.6e-6, loss 4.8e-7; bf16 0 (bitwise) on all three (other draws:
    ``tests/_lm_reference.py``)."""
    gaps = model_gaps(ARCH, dtype)
    assert max(gaps.values()) <= ATOL[dtype], gaps


def test_greedy_generate_matches_reference(jserve):
    """The batch carries ``frames`` beside ``tokens``; the engine serves
    it unchanged."""
    p = pair(ARCH, "f32")
    batch = inputs(p.cfg, 4, 10, seed=21)
    want, logits = reference_generate(jserve, p, as_jax(batch, "f32"),
                                      "f32", 6)
    got = ServeEngine(p.arch, p.params, max_len=32, device="cpu").generate(
        as_torch(batch, "f32"), 6)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert tokens_held(got, want, logits, ATOL["f32"]) >= want.size // 2


def test_decode_matches_prefill():
    """Three teacher-forced decode steps against a prefill over the same
    tokens and frames, from the port's own init."""
    cfg = get_config(ARCH, reduced=True)
    arch = make_arch(cfg)
    params = tcommon.init_params(torch.Generator().manual_seed(0),
                                 arch.param_specs(cfg), device="cpu")
    full = as_torch(inputs(cfg, 2, 15, seed=3))
    with torch.inference_mode():
        st, n, _ = arch.prefill(params, dict(full, tokens=full["tokens"][
            :, :12]), cfg, CTX, max_len=20)
        for i in range(12, 15):
            st, n, step = arch.decode(params, st, n,
                                      full["tokens"][:, i:i + 1], cfg, CTX)
        _, _, ref = arch.prefill(params, full, cfg, CTX, max_len=20)
    assert n == 15
    assert float((step[:, -1] - ref[:, -1]).abs().max()) < BF16_ATOL


def test_encoder_blockwise_matches_reference_dense():
    """At full size the encoder's self-attention over 1,500 frames takes
    the blockwise path, non-causally, with ``kv_len`` set by the padding
    of the last KV tile.  Here 21 frames in tiles of 8 queries and 16
    keys (a ragged last tile each way) against the reference's dense
    encoder, float32."""
    p = pair(ARCH, "f32")
    cfg = dataclasses.replace(p.cfg, attn_impl="blockwise", block_q=8,
                              block_k=16)
    frames = np.random.default_rng(8).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    want = run_reference(jwh.encode, "f32", p.jparams, jnp.asarray(frames),
                         cfg=p.jcfg, ctx=JCTX)
    got = twh.encode(p.params, torch.from_numpy(frames), cfg, CTX)
    dense = twh.encode(p.params, torch.from_numpy(frames), p.cfg, CTX)
    assert max_err(want, got) <= 1e-4
    assert float((got - dense).abs().max()) <= 1e-4


def test_cross_cache_holds_the_encoder_kv():
    """Prefill's cross cache is each decoder layer's K/V of the encoder
    output, in its dtype, used as it is by every decode step; the self
    cache is bfloat16."""
    p = pair(ARCH, "f32")
    batch = inputs(p.cfg, 2, 6, seed=9)
    jst, _, _ = run_reference(p.jarch.prefill, "f32", p.jparams,
                              as_jax(batch, "f32"), cfg=p.jcfg, ctx=JCTX,
                              max_len=12)
    tb = as_torch(batch, "f32")
    with torch.inference_mode():
        st, n, _ = p.arch.prefill(p.params, tb, p.cfg, CTX, max_len=12)
        enc = twh.encode(p.params, tb["frames"], p.cfg, CTX)
        cross = {k: v.clone() for k, v in st["cross"].items()}
        p.arch.decode(p.params, st, n, tb["tokens"][:, :1], p.cfg, CTX)
    shape = (p.cfg.n_layers, 2, p.cfg.n_kv, FRAMES, p.cfg.d_head)
    assert st["cross"]["k"].shape == shape
    assert st["cross"]["k"].dtype == torch.float32
    assert st["self"]["k"].dtype == torch.bfloat16
    assert all(torch.equal(cross[k], st["cross"][k]) for k in cross)
    for k in ("k", "v"):
        scale = float(np.abs(np.asarray(jst["cross"][k])).max())
        assert max_err(jst["cross"][k], st["cross"][k]) <= 1e-5 * scale
    ref = twh._cross_kv(p.params, enc, p.cfg)
    assert torch.equal(ref["k"], st["cross"]["k"])


@pytest.mark.parametrize("pos0", [0, 5, 62, 63, 70])
def test_decoder_positions_clamp_as_the_reference(pos0):
    """The learned positions start at ``pos0``, clamped to
    ``[0, max_seq - s]`` as the reference's ``dynamic_slice`` clamps it
    (max_seq 64 at the reduced size)."""
    p = pair(ARCH, "f32")
    toks = np.arange(4, dtype=np.int32).reshape(2, 2)
    want = jax.jit(jwh._embed_dec, static_argnums=3)(
        p.jparams, jnp.asarray(toks), jnp.int32(pos0), p.jcfg)
    got = twh._embed_dec(p.params, torch.from_numpy(toks), pos0, p.cfg)
    assert max_err(want, got) == 0.0
