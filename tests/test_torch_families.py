"""What the zamba2, xLSTM and Whisper slice adds to the shared substrate,
against ``repro`` on the CPU.

Attention with a cross-attention source (``kv_x``: K/V from the source,
no rope on K, keys numbered from 0, a cross cache read as it is) and at
the shared block's 2·d_model input with a d_model output; the registry
building all ten configs, with their PSpec trees, decode-state specs,
input specs and counts against the reference's; the new decode-state
initializers on the card by default; and the tree helpers and
``params_from_reference`` on tuples (xLSTM's states).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import CELLS as JCELLS, input_specs as jinput_specs
from repro.models import attention as jattn, common as jcommon
from repro.models.registry import make_arch as jmake_arch
from repro.roofline import analysis as jroof
from repro_torch import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import (CELLS, ShapeCell, input_specs, make_arch,
                               make_batch)
from repro_torch.models import attention as tattn, common as tcommon
from repro_torch.models import mamba2 as tmb, whisper as twh
from repro_torch.models import xlstm as txl, zamba2 as tzb
from repro_torch.roofline import analysis as troof

from _lm_reference import CTX, JCTX, OTHER_IDS, max_err

# the reference's attention, jitted once per config (float32 throughout)
jattention = jax.jit(jattn.attention,
                     static_argnames=("c", "ctx", "pos0", "cache_len"))


def _attn_params(c, seed, d_out=None):
    jp = jcommon.init_params(jax.random.PRNGKey(seed),
                             jattn.attn_param_specs(c))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    if d_out is not None:              # wo: (n_heads, d_head, d_out)
        jp["wo"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (c.n_heads, c.d_head, d_out)) / 8
    return jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu")


CROSS_CASES = {
    # a transformer-like config with rope and qk-norm: rope on q only
    "rope_qknorm": dict(d_model=64, n_heads=4, n_kv=2, d_head=16,
                        causal=False, rope_theta=10000.0, qk_norm=True,
                        impl="dense"),
    # whisper's: no rope, MHA
    "whisper": dict(d_model=64, n_heads=4, n_kv=4, d_head=16, causal=False,
                    rope_theta=None, impl="dense"),
    # blockwise over a source of 21 positions in tiles of 8
    "blockwise": dict(d_model=64, n_heads=4, n_kv=4, d_head=16,
                      causal=False, rope_theta=None, impl="blockwise",
                      block_q=4, block_k=8),
}


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_attention_cross_source_matches_reference(case, cached):
    """Queries from x (7 positions at pos0 = 5), K/V from ``kv_x`` (21
    positions); with a cache, the cache holds the source's K/V (as
    Whisper's prefill builds it) and is read, not written."""
    kw = CROSS_CASES[case]
    jc, tc = jattn.AttnCfg(**kw), tattn.AttnCfg(**kw)
    jp, tp = _attn_params(jc, 11)
    rng = np.random.default_rng(12)
    x, src = (rng.standard_normal(s).astype(np.float32)
              for s in ((2, 7, 64), (2, 21, 64)))
    if cached:
        cache = {k: np.asarray(jnp.einsum("bsd,dhk->bhsk", jnp.asarray(src),
                                          jp[f"w{k}"])) for k in ("k", "v")}
        if kw.get("qk_norm"):
            cache["k"] = np.asarray(jcommon.rms_norm(jnp.asarray(cache["k"]),
                                                     jp["k_norm"]))
        want, jnew = jattention(jp, jnp.asarray(x), jc, JCTX, pos0=5,
                                cache={k: jnp.asarray(v)
                                       for k, v in cache.items()},
                                kv_x=jnp.zeros((2, 1, 64)))
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        got, tnew = tattn.attention(tp, torch.from_numpy(x), tc, CTX,
                                    pos0=5, cache=tcache,
                                    kv_x=torch.zeros((2, 1, 64)))
        assert tnew is tcache
        assert all(np.array_equal(cache[k], tcache[k].numpy())
                   for k in cache)
    else:
        want, _ = jattention(jp, jnp.asarray(x), jc, JCTX, pos0=5,
                             kv_x=jnp.asarray(src))
        got, _ = tattn.attention(tp, torch.from_numpy(x), tc, CTX, pos0=5,
                                 kv_x=torch.from_numpy(src))
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    assert got.shape == (2, 7, 64)
    assert max_err(want, got) <= 1e-5 * scale, case


@pytest.mark.parametrize("cached", [False, True])
def test_attention_wide_input_narrow_output(cached):
    """zamba2's shared block: the input is concat(h, h0), 2·d_model wide
    (``AttnCfg.d_model``), and ``wo`` projects the heads back to d_model.
    The output projection contracts over wo's own (n_heads·d_head,
    d_out) shape.  Without a cache and with one (an 8-token prompt, then
    one position)."""
    c = dict(d_model=128, n_heads=4, n_kv=4, d_head=16, impl="dense")
    jc, tc = jattn.AttnCfg(**c), tattn.AttnCfg(**c)
    jp, tp = _attn_params(jc, 13, d_out=64)
    assert tuple(tp["wo"].shape) == (4, 16, 64)
    x = np.random.default_rng(14).standard_normal((2, 9, 128)).astype(
        np.float32)
    if not cached:
        want, _ = jattention(jp, jnp.asarray(x), jc, JCTX)
        got, _ = tattn.attention(tp, torch.from_numpy(x), tc, CTX)
        tol = 1e-5
    else:
        _, jcache = jattention(jp, jnp.asarray(x[:, :8]), jc, JCTX,
                               cache=jattn.make_cache(jc, 2, 12),
                               cache_len=0)
        want, _ = jattention(jp, jnp.asarray(x[:, 8:]), jc, JCTX, pos0=8,
                             cache=jcache, cache_len=8)
        tcache = tattn.make_cache(tc, 2, 12, device="cpu")
        tattn.attention(tp, torch.from_numpy(x[:, :8]), tc, CTX,
                        cache=tcache, cache_len=0)
        got, _ = tattn.attention(tp, torch.from_numpy(x[:, 8:]), tc, CTX,
                                 pos0=8, cache=tcache, cache_len=8)
        tol = 2 ** -8                  # the bf16 cache (test_torch_models)
    assert got.shape == (2, 9 if not cached else 1, 64)
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    assert max_err(want, got) <= tol * scale


# ---------------------------------------------------------------------------
# registry, specs and counts
# ---------------------------------------------------------------------------
REFERENCE_COUNTS = {"zamba2-7b": 6_889_222_352, "xlstm-125m": 104_771_408,
                    "whisper-tiny": 49_043_328}


def _rows(tree, leaves):
    return [(tuple(s.shape), tuple(s.logical),
             str(s.dtype).split(".")[-1] if isinstance(s.dtype, torch.dtype)
             else jnp.dtype(s.dtype).name, s.init, s.init_scale)
            for s in leaves(tree)]


@pytest.mark.parametrize("arch_id", OTHER_IDS)
def test_specs_and_counts_match_reference(arch_id):
    """Full-size PSpec trees (shapes, logical axes, dtypes, inits, in the
    reference's leaf order), decode-state specs (xLSTM's tuples in
    order), input specs per cell and the roofline counts."""
    jcfg, cfg = jget_config(arch_id), get_config(arch_id)
    jarch, arch = jmake_arch(jcfg), make_arch(cfg)

    def jleaves(t):
        return jax.tree.leaves(t, is_leaf=jcommon.is_pspec)

    assert _rows(arch.param_specs(cfg), tcommon.tree_leaves) == \
        _rows(jarch.param_specs(jcfg), jleaves)
    for b, max_len in ((1, 64), (4, 128)):
        assert _rows(arch.decode_state_specs(cfg, b, max_len),
                     tcommon.tree_leaves) == \
            _rows(jarch.decode_state_specs(jcfg, b, max_len), jleaves)
    assert troof.n_params(cfg) == jroof.n_params(jcfg) == \
        REFERENCE_COUNTS[arch_id]
    assert troof.n_active_params(cfg) == jroof.n_active_params(jcfg)
    for name, cell in CELLS.items():
        assert troof.model_flops(cfg, cell) == \
            jroof.model_flops(jcfg, JCELLS[name])
        want = jinput_specs(jcfg, JCELLS[name])
        assert {k: (v.shape, str(v.dtype).split(".")[-1])
                for k, v in input_specs(cfg, cell).items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_make_arch_builds_all_ten(arch_id):
    """Every config builds, reduced and full, and counts as the
    reference's ``param_count``."""
    for reduced in (False, True):
        cfg = get_config(arch_id, reduced=reduced)
        jcfg = jget_config(arch_id, reduced=reduced)
        arch = make_arch(cfg)
        assert troof.n_params(cfg) == jcommon.param_count(
            jmake_arch(jcfg).param_specs(jcfg))
        assert tcommon.param_count(arch.param_specs(cfg)) == \
            troof.n_params(cfg)


STATE_INITS = {
    "mamba": lambda cfg, **kw: tmb.mamba_state_init(cfg, 2, **kw),
    "zamba": lambda cfg, **kw: tzb.zamba_state_init(cfg, 2, 16, **kw),
    "xlstm": lambda cfg, **kw: txl.xlstm_state_init(cfg, 2, **kw),
    "whisper": lambda cfg, **kw: twh.whisper_state_init(cfg, 2, 16, **kw),
}
STATE_ARCH = {"mamba": "zamba2-7b", "zamba": "zamba2-7b",
              "xlstm": "xlstm-125m", "whisper": "whisper-tiny"}


@pytest.mark.parametrize("name", sorted(STATE_INITS))
def test_state_inits_default_to_the_card(name):
    """``device=None`` is the card: without CUDA the initializer raises,
    through ``make_arch`` too; ``device="cpu"`` builds the specs' shapes
    and dtypes."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: device=None runs on the card")
    cfg = get_config(STATE_ARCH[name], reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        STATE_INITS[name](cfg)
    if name != "mamba":
        with pytest.raises(RuntimeError, match="CUDA"):
            make_arch(cfg).decode_state_init(cfg, 2, 16)
    got = STATE_INITS[name](cfg, device="cpu")
    specs = (tmb.mamba_state_specs(cfg, 2) if name == "mamba"
             else make_arch(cfg).decode_state_specs(cfg, 2, 16))
    pairs = list(zip(tcommon.tree_leaves(specs),
                     tcommon.tree_leaves(got, torch.is_tensor)))
    assert len(pairs) == len(list(tcommon.tree_leaves(specs)))
    for s, t in pairs:
        assert t.shape == s.shape and t.dtype == s.dtype
        assert t.device.type == "cpu"


def test_make_batch_carries_frames_for_whisper():
    cfg = get_config("whisper-tiny", reduced=True)
    batch = make_batch(cfg, ShapeCell("smoke", 16, 3, "prefill"),
                       torch.Generator().manual_seed(2))
    assert batch["frames"].shape == (3, 16, cfg.d_model)
    assert batch["frames"].dtype == torch.bfloat16
    assert batch["tokens"].shape == (3, 16)


def test_tree_helpers_and_converter_walk_tuples():
    """xLSTM's states are tuples: the tree helpers walk them in order
    (``jax.tree.leaves``' order) and the converter carries them."""
    tree = {"b": (torch.ones(2), torch.zeros(3)), "a": torch.ones(1)}
    assert [t.shape[0] for t in tcommon.tree_leaves(tree, torch.is_tensor)] \
        == [1, 2, 3]
    doubled = tcommon.tree_map(lambda t: 2 * t, tree, torch.is_tensor)
    assert isinstance(doubled["b"], tuple) and float(doubled["b"][0][0]) == 2
    ref = {"s": (np.ones((2, 2), np.float32), np.full(2, -np.inf,
                                                      np.float32))}
    got = params_from_reference(ref, device="cpu")
    assert isinstance(got["s"], tuple)
    assert bool(torch.isneginf(got["s"][1]).all())
    assert [t.shape for t in tcommon.tree_leaves(got, torch.is_tensor)] == \
        [t.shape for t in jax.tree.leaves(ref)]
