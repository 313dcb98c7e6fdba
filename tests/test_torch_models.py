"""The port's transformer family against ``repro``'s, on the CPU.

For each of the seven transformer-family configs at ``reduced()``, the
reference's init (``PRNGKey(0)``) is carried into the port and the same
seeded tokens go through both packages: prefill logits, one decode step
and the loss's forward value, once with the params cast to float32 and
once in bfloat16 (``tests/_lm_reference.py`` states both tolerances
and why bfloat16 is held against the reference run op by op).  Module
cases hold the norms, rope, softcap, the MLP activations, the MoE layer
(its routing, with the tie rule, and aux losses), dense against
blockwise attention across tiles at a window, the fused QKV projection,
gemma2's embedding scale and logit rounding, and the registry, configs,
PSpec trees and counts against the reference's.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import CELLS as JCELLS, input_specs as jinput_specs
from repro.models import attention as jattn, common as jcommon
from repro.models import mlp as jmlp, moe as jmoe, transformer as jtf
from repro.models.registry import make_arch as jmake_arch
from repro.roofline import analysis as jroof
from repro_torch import config_from_reference, params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import (CELLS, MoeCfg, ShapeCell, input_specs,
                               make_arch, make_batch)
from repro_torch.models import attention as tattn, common as tcommon
from repro_torch.models import mlp as tmlp, moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.roofline import analysis as troof
from repro_torch.serve import ServeEngine
from repro_torch.sharding import ShardCtx

from _lm_reference import (ATOL, BF16_ATOL, CTX, DTYPES, JCTX,
                           TRANSFORMER_IDS, as_jax, as_torch, inputs,
                           max_err, pair, run_reference)

# module cases: float32 agrees to float32 rounding (same op order up to
# summation, no bfloat16 cast inside), bfloat16 to one bf16 ulp of the
# output's magnitude
MOD_ATOL = {"f32": 1e-5, "bf16": 2 ** -7}


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair_arrays(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# ---------------------------------------------------------------------------
# the whole model, seven configs x two dtypes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch_id", TRANSFORMER_IDS)
def test_prefill_decode_and_loss_match_reference(arch_id, dtype):
    """A prompt of 12 positions (the VLM's patches among them, so every
    config shares the reference's op shapes), one decode step, and the
    loss over the prompt."""
    p = pair(arch_id, dtype)
    b, s = 2, 12 - p.cfg.n_patches
    full = inputs(p.cfg, b, s + 1, seed=1)
    prompt = dict(full, tokens=full["tokens"][:, :s])
    nxt = full["tokens"][:, s:]
    jst, jlen, jpre = run_reference(p.jarch.prefill, dtype, p.jparams,
                                    as_jax(prompt), cfg=p.jcfg, ctx=JCTX,
                                    max_len=20)
    _, _, jdec = run_reference(p.jarch.decode, dtype, p.jparams, jst, jlen,
                               jnp.asarray(nxt), cfg=p.jcfg, ctx=JCTX)
    jloss, jmet = run_reference(p.jarch.loss, dtype, p.jparams,
                                as_jax(prompt), cfg=p.jcfg, ctx=JCTX)
    with torch.inference_mode():
        st, length, pre = p.arch.prefill(p.params, as_torch(prompt), p.cfg,
                                         CTX, max_len=20)
        _, _, dec = p.arch.decode(p.params, st, length,
                                  torch.from_numpy(nxt), p.cfg, CTX)
        loss, met = p.arch.loss(p.params, as_torch(prompt), p.cfg, CTX)
    assert length == int(jlen) and pre.shape == jpre.shape
    tol = ATOL[dtype]
    assert max_err(jpre, pre) <= tol, (arch_id, dtype, "prefill")
    assert max_err(jdec, dec) <= tol, (arch_id, dtype, "decode")
    assert abs(float(jloss) - float(loss)) <= tol, (arch_id, dtype, "loss")
    assert abs(float(jmet["aux"]) - float(met["aux"])) <= tol


@pytest.mark.parametrize("arch_id", TRANSFORMER_IDS)
def test_decode_matches_prefill(arch_id):
    """The reference's invariant on the port alone, from the port's own
    init: teacher-forced decode logits equal a prefill over s+1 tokens
    within the reference's bound (5e-2, bfloat16)."""
    cfg = get_config(arch_id, reduced=True)
    arch = make_arch(cfg)
    gen = torch.Generator().manual_seed(0)
    params = tcommon.init_params(gen, arch.param_specs(cfg), device="cpu")
    b, s = 2, 12
    full = as_torch(inputs(cfg, b, s + 1, seed=3))
    prompt = dict(full, tokens=full["tokens"][:, :s])
    with torch.inference_mode():
        st, n, _ = arch.prefill(params, prompt, cfg, CTX, max_len=s + 8)
        _, n2, step = arch.decode(params, st, n, full["tokens"][:, s:],
                                  cfg, CTX)
        _, _, ref = arch.prefill(params, full, cfg, CTX, max_len=s + 8)
    assert n2 == n + 1
    err = float((step[:, -1] - ref[:, -1]).abs().max())
    assert err < BF16_ATOL, (arch_id, err)


# ---------------------------------------------------------------------------
# module cases
# ---------------------------------------------------------------------------
def _norm_case(name, rng):
    x, sc, bias = _arrays(rng, (3, 5, 64), (64,), (64,))
    pos = np.arange(5, dtype=np.int32)[None] + 7
    return {
        "rms_norm": (lambda m, x, sc, b: m.rms_norm(x, sc, 1e-5)),
        "rms_norm_plus_one": (
            lambda m, x, sc, b: m.rms_norm(x, sc, 1e-6, plus_one=True)),
        "layer_norm": (lambda m, x, sc, b: m.layer_norm(x, sc, b)),
        "rope": (lambda m, x, sc, b: m.rope(
            x, (jnp.asarray(pos) if m is jcommon else torch.from_numpy(pos)),
            1e6)),
        "softcap": (lambda m, x, sc, b: m.softcap(x * 40.0, 30.0)),
    }[name], (x, sc, bias)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["rms_norm", "rms_norm_plus_one",
                                  "layer_norm", "rope", "softcap"])
def test_numerics_match_reference(name, dtype):
    fn, arrays = _norm_case(name, np.random.default_rng(5))
    (jx, jsc, jb), (tx, tsc, tb) = _pair_arrays(arrays, dtype)
    want, got = fn(jcommon, jx, jsc, jb), fn(tcommon, tx, tsc, tb)
    assert got.dtype == DTYPES[dtype][1] or name == "softcap"
    scale = max(1.0, float(np.max(np.abs(np.asarray(want, np.float32)))))
    assert max_err(want, got) <= MOD_ATOL[dtype] * scale, name


def test_positions_and_cross_entropy_match_reference():
    got = tcommon.sinusoidal_positions(40, 32)
    assert max_err(jcommon.sinusoidal_positions(40, 32), got) <= 1e-6
    rng = np.random.default_rng(6)
    logits, = _arrays(rng, (3, 7, 50))
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for kw in ({}, {"z_loss": 1e-3}):
        for m in (None, mask):
            want = jcommon.cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels),
                None if m is None else jnp.asarray(m), **kw)
            got = tcommon.cross_entropy(
                torch.from_numpy(logits), torch.from_numpy(labels),
                None if m is None else torch.from_numpy(m), **kw)
            assert abs(float(want) - float(got)) <= 1e-5


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "sqrelu", "gelu"])
def test_mlp_matches_reference(act, dtype):
    rng = np.random.default_rng(7)
    gated = act in tmlp.GATED
    w_in_shape = (64, 2, 96) if gated else (64, 96)
    x, w_in, w_out = _arrays(rng, (2, 5, 64), w_in_shape, (96, 64))
    w_in, w_out = w_in / 8, w_out / 10
    (jx, jw, jo), (tx, tw, to) = _pair_arrays([x, w_in, w_out], dtype)
    want = jmlp.mlp({"w_in": jw, "w_out": jo}, jx, act, JCTX)
    got = tmlp.mlp({"w_in": tw, "w_out": to}, tx, act, CTX)
    scale = float(np.max(np.abs(np.asarray(want, np.float32))))
    assert got.dtype == DTYPES[dtype][1]
    assert max_err(want, got) <= MOD_ATOL[dtype] * scale, act


def test_top_k_breaks_ties_as_jax_does():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.5, 0.5, 0.5, 0.5, 0.5]],
                 np.float32)
    jw, je = jax.lax.top_k(jnp.asarray(x), 3)
    tw, te = tmoe.top_k(torch.from_numpy(x), 3)
    assert np.array_equal(np.asarray(je), te.numpy())
    assert te.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert np.array_equal(np.asarray(jw), tw.numpy())


MOE_CASES = {
    # reduced qwen2-moe (shared experts; dropless at capacity 4)
    "qwen2-moe": dict(arch="qwen2-moe-a2.7b"),
    # capacity 1: the overflow bin drops tokens; padded experts
    "overflow_padded": dict(arch="qwen2-moe-a2.7b", capacity_factor=1.0,
                            pad_experts_to=6),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_reference(case):
    """float32 (bfloat16 MoE layers are held by the whole-model tests of
    olmoe and qwen2-moe): the output, the routing and the aux losses."""
    kw = dict(MOE_CASES[case])
    jm = dataclasses.replace(jget_config(kw.pop("arch"), reduced=True).moe,
                             **kw)
    m = MoeCfg(**{f.name: getattr(jm, f.name)
                  for f in dataclasses.fields(MoeCfg)})
    d = 64
    jp = jcommon.init_params(jax.random.PRNGKey(2),
                             jmoe.moe_param_specs(d, jm))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    x, = _arrays(np.random.default_rng(8), (2, 12, d))
    want, jaux = run_reference(jmoe.moe_ffn, "f32", jp, jnp.asarray(x),
                               m=jm, ctx=JCTX)
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), m, CTX)
    # routing: the same experts for every token
    pad = np.arange(m.n_experts_padded) >= m.n_experts
    jlog = jnp.where(pad, -1e30, jnp.asarray(x.reshape(-1, d)) @ jp["router"])
    _, je = jax.lax.top_k(jax.nn.softmax(jlog, axis=-1), m.top_k)
    tlog = torch.where(torch.from_numpy(pad), -1e30,
                       torch.from_numpy(x.reshape(-1, d)) @ tp["router"])
    _, te = tmoe.top_k(torch.softmax(tlog, dim=-1), m.top_k)
    assert np.array_equal(np.asarray(je), te.numpy())
    scale = max(1.0, float(np.max(np.abs(np.asarray(want)))))
    assert max_err(want, got) <= MOD_ATOL["f32"] * scale, case
    for key in ("load_balance", "z_loss", "aux_total"):
        assert abs(float(jaux[key]) - float(aux[key])) <= 1e-5 * max(
            1.0, abs(float(jaux[key]))), key


# the reference's attention, jitted once per config (float32 throughout)
jattention = jax.jit(jattn.attention,
                     static_argnames=("c", "ctx", "pos0", "cache_len"))

ATTN_CASES = {
    # window 6 with 4-query / 8-key tiles: bands that start mid-tile
    "window_softcap": dict(window=6, softcap=5.0),
    "causal_gqa4": dict(window=None, softcap=50.0, n_kv=1),
}


def _attn_cfgs(case, **extra):
    kw = dict(ATTN_CASES[case])
    base = dict(d_model=64, n_heads=4, n_kv=2, d_head=16, qk_norm=True,
                block_q=4, block_k=8, scale=0.3)
    base.update(kw)
    base.update(extra)
    return jattn.AttnCfg(**base), tattn.AttnCfg(**base)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_dense_vs_blockwise(case, cached):
    """Blockwise (tiles of 4 queries, 8 keys) against the reference's and
    against dense: a 21-token prompt (a ragged last tile) without a
    cache, or written into the bf16 cache after 5 cached tokens
    (positions 5..25: bands that start mid-tile).  Dense is held against
    the reference's by the whole-model tests."""
    jc, tc = _attn_cfgs(case, impl="blockwise")
    jp = jcommon.init_params(jax.random.PRNGKey(4),
                             jattn.attn_param_specs(jc))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    x, = _arrays(np.random.default_rng(9), (2, 26, 64))

    def port(c):
        if not cached:
            return tattn.attention(tp, torch.from_numpy(x[:, :21]), c, CTX)[0]
        cache = tattn.make_cache(c, 2, 40, device="cpu")
        tattn.attention(tp, torch.from_numpy(x[:, :5]), c, CTX, cache=cache,
                        cache_len=0)
        return tattn.attention(tp, torch.from_numpy(x[:, 5:]), c, CTX,
                               pos0=5, cache=cache, cache_len=5)[0]

    if cached:
        _, jcache = jattention(jp, jnp.asarray(x[:, :5]), jc, JCTX,
                               cache=jattn.make_cache(jc, 2, 40), cache_len=0)
        want, _ = jattention(jp, jnp.asarray(x[:, 5:]), jc, JCTX, pos0=5,
                             cache=jcache, cache_len=5)
    else:
        want, _ = jattention(jp, jnp.asarray(x[:, :21]), jc, JCTX)
    got = port(tc)
    # float32, but the cache rounds K/V to bfloat16: an element whose
    # float32 value differs in its last bits between the packages can
    # round to the neighbouring bf16 value, 2**-8 relative
    scale = max(1.0, float(np.max(np.abs(np.asarray(want)))))
    assert max_err(want, got) <= (2 ** -8 if cached else 1e-5) * scale
    # dense reads the same cache: float32 rounding apart
    dense = port(dataclasses.replace(tc, impl="dense"))
    assert float((dense - got).abs().max()) <= 1e-5 * scale


def test_attention_fused_qkv_matches_reference():
    """``fuse_qkv=True``: one (D, H + 2 Hkv, Dh) projection, prefill into
    the cache and one decode step, against the reference's."""
    jc, tc = _attn_cfgs("window_softcap", fuse_qkv=True, impl="dense")
    jp = jcommon.init_params(jax.random.PRNGKey(5),
                             jattn.attn_param_specs(jc))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    assert set(tp) == {"wqkv", "wo", "q_norm", "k_norm"}
    x, = _arrays(np.random.default_rng(10), (2, 9, 64))
    jcache, tcache = jattn.make_cache(jc, 2, 16), tattn.make_cache(
        tc, 2, 16, device="cpu")
    want, jcache = jattention(jp, jnp.asarray(x[:, :8]), jc, JCTX,
                              cache=jcache, cache_len=0)
    got, tcache = tattn.attention(tp, torch.from_numpy(x[:, :8]), tc, CTX,
                                  cache=tcache, cache_len=0)
    assert max_err(want, got) <= 1e-4
    assert max_err(jcache["k"], tcache["k"]) == 0.0
    want, _ = jattention(jp, jnp.asarray(x[:, 8:]), jc, JCTX, pos0=8,
                         cache=jcache, cache_len=8)
    got, _ = tattn.attention(tp, torch.from_numpy(x[:, 8:]), tc, CTX,
                             pos0=8, cache=tcache, cache_len=8)
    assert max_err(want, got) <= 1e-4


def test_gemma2_embed_scale_and_unembed_rounding():
    """At gemma2-27b's width, sqrt(4608) in bfloat16 is 68.0 and the
    embedding is scaled by it, not by 67.88; the tied unembedding rounds
    its logits to bfloat16 before the float32 softcap."""
    cfg = dataclasses.replace(get_config("gemma2-27b"), vocab=40)
    jcfg = dataclasses.replace(jget_config("gemma2-27b"), vocab=40)
    assert torch.tensor(math.sqrt(cfg.d_model), dtype=torch.bfloat16) == 68.0
    rng = np.random.default_rng(11)
    emb, h = _arrays(rng, (40, cfg.d_model), (1, 3, cfg.d_model))
    (jemb, jh), (temb, th) = _pair_arrays([emb / 20, h], "bf16")
    toks = np.array([[0, 7, 39]], np.int32)
    want = jtf.embed({"embed": jemb}, jnp.asarray(toks), jcfg, JCTX)
    got = ttf.embed({"embed": temb}, torch.from_numpy(toks), cfg, CTX)
    assert torch.equal(got, temb[toks] * 68.0)
    assert max_err(want, got) == 0.0
    want = jtf.unembed({"embed": jemb}, jh, jcfg, JCTX)
    got = ttf.unembed({"embed": temb}, th, cfg, CTX)
    rounded = (th @ temb.T).float()
    assert torch.equal(got, 30.0 * torch.tanh(rounded / 30.0))
    assert max_err(want, got) <= 1e-5


# ---------------------------------------------------------------------------
# registry, configs, specs and counts
# ---------------------------------------------------------------------------
def test_card_by_default_and_no_fallback():
    """``device=None`` is the card; without CUDA it raises, never runs on
    the host.  A mesh is the sharded slice's."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: device=None runs on the card")
    cfg = get_config("qwen3-14b", reduced=True)
    arch = make_arch(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcommon.init_params(torch.Generator(), arch.param_specs(cfg))
    params = tcommon.init_params(torch.Generator(), arch.param_specs(cfg),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(arch, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        arch.decode_state_init(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.make_cache(ttf.attn_cfg_for(cfg, "global"), 2, 16)
    with pytest.raises(NotImplementedError, match="sharded"):
        ShardCtx(mesh=object())


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_configs_match_reference(arch_id):
    for reduced in (False, True):
        want = jget_config(arch_id, reduced=reduced)
        assert get_config(arch_id, reduced=reduced) == \
            config_from_reference(want)


def _spec_rows(tree, is_leaf):
    return [(tuple(s.shape), tuple(s.logical), jnp.dtype(s.dtype).name,
             s.init, s.init_scale)
            for s in jax.tree.leaves(tree, is_leaf=is_leaf)]


@pytest.mark.parametrize("arch_id", TRANSFORMER_IDS)
def test_specs_and_counts_match_reference(arch_id):
    """Full-size PSpec trees (shapes, logical axes, dtypes, inits, in
    the reference's leaf order), cache specs, input specs per cell and
    the roofline counts."""
    jcfg, cfg = jget_config(arch_id), get_config(arch_id)
    jarch, arch = jmake_arch(jcfg), make_arch(cfg)
    rows = _spec_rows(jarch.param_specs(jcfg), jcommon.is_pspec)
    got = [(s.shape, s.logical, str(s.dtype).split(".")[-1], s.init,
            s.init_scale)
           for s in tcommon.tree_leaves(arch.param_specs(cfg))]
    assert got == rows
    assert [r[:2] for r in _spec_rows(jarch.decode_state_specs(jcfg, 4, 64),
                                      jcommon.is_pspec)] == \
        [(s.shape, s.logical) for s in tcommon.tree_leaves(
            arch.decode_state_specs(cfg, 4, 64))]
    assert troof.n_params(cfg) == jroof.n_params(jcfg)
    assert troof.n_active_params(cfg) == jroof.n_active_params(jcfg)
    for name, cell in CELLS.items():
        assert troof.model_flops(cfg, cell) == \
            jroof.model_flops(jcfg, JCELLS[name])
        want = jinput_specs(jcfg, JCELLS[name])
        specs = input_specs(cfg, cell)
        assert {k: (v.shape, str(v.dtype).split(".")[-1])
                for k, v in specs.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("arch_id", ["internvl2-76b", "qwen3-14b"])
def test_make_batch_and_caches(arch_id):
    cfg = get_config(arch_id, reduced=True)
    cell = ShapeCell("smoke", 16, 3, "prefill")
    gen = torch.Generator().manual_seed(1)
    batch = make_batch(cfg, cell, gen)
    specs = input_specs(cfg, cell)
    for k, spec in specs.items():
        assert batch[k].shape == spec.shape and batch[k].dtype == spec.dtype
    t = batch["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab
    caches = make_arch(cfg).decode_state_init(cfg, 3, 24, device="cpu")
    for c in caches.values():
        for x in c.values():
            assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
            assert x.shape == (cfg.n_units, 3, cfg.n_kv, 24, cfg.d_head)


def test_params_from_reference_carries_bf16_bits():
    a = jax.random.normal(jax.random.PRNGKey(3), (5, 7), jnp.bfloat16)
    tree = {"a": np.asarray(a), "n": {"b": np.arange(6, dtype=np.int32)}}
    got = params_from_reference(tree, device="cpu")
    assert got["a"].dtype == torch.bfloat16
    assert np.array_equal(got["a"].view(torch.int16).numpy(),
                          np.asarray(a).view(np.int16))
    assert got["n"]["b"].dtype == torch.int32
    f32 = params_from_reference(tree, device="cpu", dtype=torch.float32)
    assert f32["a"].dtype == torch.float32
    assert f32["n"]["b"].dtype == torch.int32
    assert torch.equal(f32["a"], got["a"].float())


def test_init_params_draws_stacked_tensors_in_slices(monkeypatch):
    """A stacked tensor is drawn slice by slice into its dtype, with the
    reference's fan-in and scale; one seed gives one set of params."""
    cfg = get_config("qwen3-14b", reduced=True)
    specs = make_arch(cfg).param_specs(cfg)
    monkeypatch.setattr(tcommon, "INIT_CHUNK", 1000)
    one = tcommon.init_params(torch.Generator().manual_seed(4), specs,
                              device="cpu")
    two = tcommon.init_params(torch.Generator().manual_seed(4), specs,
                              device="cpu")
    for s, a, b in zip(tcommon.tree_leaves(specs), tcommon.tree_leaves(
            one, torch.is_tensor), tcommon.tree_leaves(two, torch.is_tensor)):
        assert a.shape == s.shape and a.dtype == s.dtype
        assert torch.equal(a, b)
        if s.init == "ones":
            assert bool((a == 1).all())
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = float(a.float().std())
            assert abs(std * math.sqrt(fan_in) - 1.0) < 0.1, (s, std)
