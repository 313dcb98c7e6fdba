"""The port's zamba2 (Mamba2 blocks and a shared attention block with
per-unit LoRA) against ``repro``'s, on the CPU.

Reduced zamba2-7b (two units of three Mamba2 blocks, the shared block
firing on the second; ``tests/_lm_reference.py`` draws the reference's
zero-initialized leaves, the LoRA ``b`` among them, so the merge takes
part): prefill, one decode step and the loss against the reference,
greedy ``generate`` against the reference's ``ServeEngine``, the port's
decode against its own prefill, the shared block alone at its 2·d_model
input with the LoRA merge's two roundings, and the wiring: which units
fire, and the state written in place.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn, zamba2 as jzb
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn, common as tcommon
from repro_torch.models import make_arch, zamba2 as tzb
from repro_torch.serve import ServeEngine

from _lm_reference import (ATOL, BF16_ATOL, CTX, DTYPES, JCTX, as_jax,
                           as_torch, inputs, max_err, model_gaps, pair,
                           reference_generate, run_reference, tokens_held)
from _serve_reference import jserve  # noqa: F401

ARCH = "zamba2-7b"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_decode_and_loss_match_reference(dtype):
    """Largest gaps seen at these inputs: f32 prefill 2.2e-5, decode
    6.2e-6, loss 3.8e-6; bf16 prefill and decode 0 (bitwise), loss
    4.8e-7 (other draws: ``tests/_lm_reference.py``)."""
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
    assert tokens_held(got, want, logits, ATOL["f32"]) >= \
        want.size // 2


def test_decode_matches_prefill():
    """The reference's invariant on the port alone, from its own init:
    three teacher-forced decode steps (the conv state, the SSM state and
    the shared block's cache) against a prefill over the same tokens."""
    cfg = get_config(ARCH, reduced=True)
    arch = make_arch(cfg)
    params = tcommon.init_params(torch.Generator().manual_seed(0),
                                 arch.param_specs(cfg), device="cpu")
    toks = torch.from_numpy(inputs(cfg, 2, 15, seed=3)["tokens"])
    with torch.inference_mode():
        st, n, _ = arch.prefill(params, {"tokens": toks[:, :12]}, cfg, CTX,
                                max_len=20)
        for i in range(12, 15):
            st, n, step = arch.decode(params, st, n, toks[:, i:i + 1], cfg,
                                      CTX)
        _, _, ref = arch.prefill(params, {"tokens": toks}, cfg, CTX,
                                 max_len=20)
    assert n == 15
    assert float((step[:, -1] - ref[:, -1]).abs().max()) < BF16_ATOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shared_block_matches_reference(dtype):
    """One firing on its own: concat(h, h0) of width 2·d_model in, d_model
    out, with the unit's LoRA merged into q/k/v (a @ b in float32, cast
    to the weights' dtype, then added), an 8-token prompt written into
    the bf16 cache and one more position read back with it.  float32 is
    held to one bf16 ulp of the output (the cache rounds K/V), bfloat16
    to one ulp as well."""
    p = pair(ARCH, dtype)
    jup = jax.tree.map(lambda t: t[1], p.jparams["units"])
    tup = tcommon.tree_map(lambda t: t[1], p.params["units"],
                           torch.is_tensor)
    assert float(np.abs(np.asarray(jup["lora_q_b"], np.float32)).max()) > 0
    rng = np.random.default_rng(4)
    h, h0 = (rng.standard_normal((2, 9, p.cfg.d_model)).astype(np.float32)
             for _ in range(2))
    jdt, tdt = DTYPES[dtype]
    jc = jattn.make_cache(jzb.shared_attn_cfg(p.jcfg), 2, 12)
    tc = tattn.make_cache(tzb.shared_attn_cfg(p.cfg), 2, 12, device="cpu")
    for lo, hi in ((0, 8), (8, 9)):
        def fire(shared, up, hh, hh0, kv, cache_len, lo=lo):
            return jzb._apply_shared(p.jcfg, JCTX, shared, up, hh, hh0, kv,
                                     lo, cache_len)
        jh, jc = run_reference(fire, dtype, p.jparams["shared"], jup,
                               jnp.asarray(h[:, lo:hi], jdt),
                               jnp.asarray(h0[:, lo:hi], jdt), jc,
                               jnp.int32(lo))
        th = tzb._apply_shared(p.cfg, CTX, p.params["shared"], tup,
                               torch.from_numpy(h[:, lo:hi]).to(tdt),
                               torch.from_numpy(h0[:, lo:hi]).to(tdt), tc,
                               lo, lo)
        assert th.shape == (2, hi - lo, p.cfg.d_model) and th.dtype == tdt
        scale = float(np.abs(np.asarray(jh, np.float32)).max())
        assert max_err(jh, th) <= 2 ** -7 * scale, (dtype, lo)
    if dtype == "bf16":
        # the merge rounds twice: bf16(a @ b), then the bf16 sum, which
        # is not the f32 sum rounded once
        w = p.params["shared"]["wq"]
        delta = (tup["lora_q_a"].float() @ tup["lora_q_b"].float()).reshape(
            w.shape)
        assert not torch.equal(w + delta.to(w.dtype),
                               (w.float() + delta).to(w.dtype))


def test_shared_block_fires_on_odd_units(monkeypatch):
    """The shared block fires on units 1, 3, ... only (13 of 27 at full
    depth), in prefill and decode alike; the state is written in place
    and returned as the same object, and the even units' caches stay
    zero."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), n_layers=12)
    arch = make_arch(cfg)
    params = tcommon.init_params(torch.Generator().manual_seed(1),
                                 arch.param_specs(cfg), device="cpu")
    fired = []
    real = tzb._apply_shared

    def spy(cfg_, ctx, shared, up, h, *rest):
        fired.append(h.shape[1])
        return real(cfg_, ctx, shared, up, h, *rest)

    monkeypatch.setattr(tzb, "_apply_shared", spy)
    toks = torch.zeros((1, 5), dtype=torch.int32)
    with torch.inference_mode():
        st, n, _ = arch.prefill(params, {"tokens": toks}, cfg, CTX,
                                max_len=8)
        before = st["ssm_0"]["ssm"].clone()
        st2, _, _ = arch.decode(params, st, n, toks[:, :1], cfg, CTX)
    assert fired == [5, 5, 1, 1]
    assert tzb.n_fires(cfg) == 2
    assert tzb.n_fires(get_config(ARCH)) == 13
    assert st2 is st and not torch.equal(st["ssm_0"]["ssm"], before)
    assert float(st["kv"]["k"][0].abs().max()) == 0.0
    assert float(st["kv"]["k"][2].abs().max()) == 0.0
    assert float(st["kv"]["k"][1].abs().max()) > 0.0
