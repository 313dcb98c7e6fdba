"""The port's xLSTM (mLSTM and sLSTM blocks) against ``repro``'s, on the
CPU.

Reduced xlstm-125m (four blocks, sLSTM at 1): prefill, one decode step
and the loss against the reference, greedy ``generate`` against the
reference's ``ServeEngine``, the port's decode against its own prefill,
the mLSTM block at the published head dim (the bfloat16 key scale), and
the states: tuples, m at -inf from ``xlstm_state_init`` and zeros in
the reference's specs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import xlstm as jxl
from repro.models.common import init_params as jinit_params
from repro_torch import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import common as tcommon, make_arch, xlstm as txl
from repro_torch.serve import ServeEngine

from _lm_reference import (ATOL, BF16_ATOL, CTX, DTYPES, JCTX, as_jax,
                           as_torch, inputs, max_err, model_gaps, pair,
                           reference_generate, run_reference, tokens_held)
from _serve_reference import jserve  # noqa: F401

ARCH = "xlstm-125m"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_decode_and_loss_match_reference(dtype):
    """Largest gaps seen at these inputs: f32 prefill 3.6e-5, decode
    2.1e-5, loss 1.4e-6; bf16 prefill 0.0146, decode 0.0293, loss
    0.0061 (other draws: ``tests/_lm_reference.py``)."""
    gaps = model_gaps(ARCH, dtype)
    assert max(gaps.values()) <= ATOL[dtype], gaps


def test_greedy_generate_matches_reference(jserve):
    p = pair(ARCH, "f32")
    batch = inputs(p.cfg, 4, 10, seed=21)
    want, logits = reference_generate(jserve, p, as_jax(batch, "f32"),
                                      "f32", 6)
    got = ServeEngine(p.arch, p.params, max_len=32, device="cpu").generate(
        as_torch(batch, "f32"), 6)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert tokens_held(got, want, logits, ATOL["f32"]) >= want.size // 2


def test_decode_matches_prefill():
    """Three teacher-forced decode steps (the sequential mLSTM and sLSTM
    steps) against a chunked prefill over the same tokens, from the
    port's own init."""
    cfg = get_config(ARCH, reduced=True)
    arch = make_arch(cfg)
    params = tcommon.init_params(torch.Generator().manual_seed(0),
                                 arch.param_specs(cfg), device="cpu")
    toks = torch.from_numpy(inputs(cfg, 2, 15, seed=3)["tokens"])
    with torch.inference_mode():
        st, n, _ = arch.prefill(params, {"tokens": toks[:, :12]}, cfg, CTX)
        for i in range(12, 15):
            st, n, step = arch.decode(params, st, n, toks[:, i:i + 1], cfg,
                                      CTX)
        _, _, ref = arch.prefill(params, {"tokens": toks}, cfg, CTX)
    assert n == 15
    assert float((step[:, -1] - ref[:, -1]).abs().max()) < BF16_ATOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_block_at_published_head_dim(dtype):
    """xlstm-125m's mLSTM head dim, 384: K is divided by sqrt(384) taken
    in the activations' dtype, 19.625 in bfloat16, not 19.596.  A
    12-token prompt (two chunks of 8, the second ragged) and one decode
    step from its state, against the reference's block: float32 to
    float32 rounding, bfloat16 to one bf16 ulp of the output (the
    block's float32 gate math rounds to bf16 once)."""
    assert float(torch.sqrt(torch.tensor(384.0, dtype=torch.bfloat16))) \
        == 19.625
    wide = dict(d_model=64, n_heads=1, d_head=192)
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), **wide)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), **wide)
    assert txl.mlstm_pdim(cfg) == 384
    jdt, tdt = DTYPES[dtype]
    jp = jinit_params(jax.random.PRNGKey(6), jxl.mlstm_param_specs(jcfg))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(7).standard_normal((2, 13, 64)).astype(
        np.float32)
    jy, jst = run_reference(lambda pp, xx: jxl.mlstm_block(pp, xx, jcfg,
                                                           JCTX),
                            dtype, jp, jnp.asarray(x[:, :12], jdt))
    ty, tst = txl.mlstm_block(tp, torch.from_numpy(x[:, :12]).to(tdt), cfg,
                              CTX)
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    scale = float(np.abs(np.asarray(jy, np.float32)).max())
    assert ty.dtype == tdt and max_err(jy, ty) <= tol * scale
    jy, _ = run_reference(lambda pp, xx, s: jxl.mlstm_block(pp, xx, jcfg,
                                                            JCTX, s),
                          dtype, jp, jnp.asarray(x[:, 12:], jdt), jst)
    ty, _ = txl.mlstm_block(tp, torch.from_numpy(x[:, 12:]).to(tdt), cfg,
                            CTX, tst)
    assert max_err(jy, ty) <= tol * scale


def test_states_are_tuples_with_m_at_minus_inf():
    """``xlstm_state_init`` starts m at -inf (so exp(m) = 0 weights the
    zero state), the reference's specs declare m ``init="zeros"``; the
    port keeps both, and its prefill's states equal the reference's."""
    p = pair(ARCH, "f32")
    st = p.arch.decode_state_init(p.cfg, 2, 16, device="cpu")
    assert set(st) == {"m_0", "s_1", "m_2", "m_3"}
    C, n, m = st["m_0"]
    assert C.shape == (2, 4, 32, 32) and bool(torch.isneginf(m).all())
    assert bool(torch.isneginf(st["s_1"][2]).all())
    specs = p.arch.decode_state_specs(p.cfg, 2, 16)
    assert all(s.init == "zeros" for s in tcommon.tree_leaves(specs))
    assert len(list(tcommon.tree_leaves(specs))) == 3 * 3 + 4
    toks = inputs(p.cfg, 2, 12, seed=5)
    jst, _, _ = run_reference(p.jarch.prefill, "f32", p.jparams,
                              as_jax(toks, "f32"), cfg=p.jcfg, ctx=JCTX)
    with torch.inference_mode():
        tst, _, _ = p.arch.prefill(p.params, as_torch(toks, "f32"), p.cfg,
                                   CTX)
    want = params_from_reference(jax.tree.map(np.asarray, jst),
                                 device="cpu")
    leaves = list(zip(tcommon.tree_leaves(want, torch.is_tensor),
                      tcommon.tree_leaves(tst, torch.is_tensor)))
    assert len(leaves) == 13
    for a, b in leaves:
        assert a.shape == b.shape
        assert bool(torch.isfinite(b).all())
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-4 * scale
