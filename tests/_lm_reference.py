"""The reference's language models beside the port's, for the parity tests.

``pair(arch_id, dtype)`` builds a reduced config in both packages, draws
the reference's init (``init_params(PRNGKey(0))``), casts it to
``dtype`` when asked and carries it into the port with
``params_from_reference``, so both packages hold the same parameters.

Where the reference scans its layers (the default), XLA compiles the
unit body as one fused computation and skips some of its bfloat16
roundings (XLA allows excess precision): its reduced gemma2-27b hidden
state moves by up to 0.78, and its logits by up to 0.56, against the
same code run op by op; a jitted prefill with the layers unrolled moves
them as much.  The port rounds where the reference's code says it does,
so in bfloat16 it is held against the reference run op by op
(``run_reference``: ``jax.disable_jit()``), where the two agree to the
bit on the logits of all seven configs.  In float32 the reference runs
jitted, as its ``ServeEngine`` runs it.

For zamba2, xLSTM and Whisper (``OTHER_IDS``) the reference's
zero-initialized leaves (LoRA ``b``, conv and gate biases, ``A_log``,
``dt_bias``, LayerNorm biases) are drawn at random before they are
carried across, so the LoRA merge and every bias take part.
"""
import contextlib
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import make_arch as jmake_arch
from repro.models.common import init_params as jinit_params
from repro.models.common import is_pspec as jis_pspec
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.sharding import ShardCtx as JShardCtx
from repro.train import make_train_step as jmake_train_step
from repro_torch import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import make_arch
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.sharding import ShardCtx
from repro_torch.train import make_train_step

TRANSFORMER_IDS = ("qwen3-14b", "yi-9b", "gemma2-27b", "nemotron-4-340b",
                   "internvl2-76b", "olmoe-1b-7b", "qwen2-moe-a2.7b")
OTHER_IDS = ("zamba2-7b", "xlstm-125m", "whisper-tiny")
# audio frames per clip in the reduced whisper's tests
FRAMES = 16
JCTX = JShardCtx(None)
CTX = ShardCtx(None)
# float32 logits: the two packages differ only in summation order, and
# where that flips the bfloat16 rounding of a cached K/V element (the
# cache is bf16 in every run); 1.7e-5 is the largest gap seen on the
# seven reduced configs
F32_ATOL = 1e-4
# bfloat16 logits: the reference's own decode-vs-prefill bound
# (tests/test_models.py); the op-by-op reference agrees to the bit
BF16_ATOL = 5e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL = {"f32": F32_ATOL, "bf16": BF16_ATOL}
# zamba2, xLSTM and Whisper are held to the same two tolerances at the
# tests' seeded inputs.  Other draws of the same shapes part further,
# with no fault on either side (40 float32 and 12 bfloat16 draws, seeds
# 0..39 and 0..11 of ``inputs``): in float32 the largest gaps of the
# prefill and decode logits are 3.3e-3 (zamba2), 5.0e-3 (Whisper) and
# 1.0e-4 (xLSTM), in bfloat16 0.223 (zamba2), 0.078 (Whisper) and 0.038
# (xLSTM).
# tests/test_torch_parity_gaps.py shows why on the draws that part
# furthest: bfloat16 caches rounding float32 values that differ in their
# last bits (held in float32 by ``f32_caches``, the float32 gaps fall
# within F32_ATOL), and the reference's fan-in rule, which draws 3-D
# projections wide enough to amplify last-bit differences (rescaled to
# their true fan-in, the float32 gaps fall under 1e-5 and the bfloat16
# ones within BF16_ATOL).


@dataclasses.dataclass
class Pair:
    jcfg: object
    jarch: object
    jparams: dict
    cfg: object
    arch: object
    params: dict


def _draw_zero_inits(params, specs, key, scale: float = 0.5):
    """``params`` with every ``init="zeros"`` leaf drawn from N(0, scale)
    in its dtype."""
    leaves, tree = jax.tree.flatten(params)
    spec_leaves = jax.tree.leaves(specs, is_leaf=jis_pspec)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(tree, [
        (jax.random.normal(k, a.shape, jnp.float32) * scale).astype(a.dtype)
        if sp.init == "zeros" else a
        for a, sp, k in zip(leaves, spec_leaves, keys)])


@functools.lru_cache(maxsize=None)
def _reference_init(arch_id: str, dtype: str):
    jcfg = jget_config(arch_id, reduced=True)
    jarch = jmake_arch(jcfg)
    specs = jarch.param_specs(jcfg)
    jp = jinit_params(jax.random.PRNGKey(0), specs)
    if arch_id in OTHER_IDS:
        jp = _draw_zero_inits(jp, specs, jax.random.PRNGKey(1))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, jarch, jax.tree.map(np.asarray, jp)


def _chip_smoke():
    """``chip_smoke.py`` (repo root) as a module, for its rescaling of
    the reference's init to the true fan-in."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


scale_to_fan_in = _chip_smoke().scale_to_fan_in


def pair(arch_id: str, dtype: str = "bf16", fan_in: bool = False) -> Pair:
    """Both packages' reduced ``arch_id`` with the same parameters; with
    ``fan_in`` both take the port's params rescaled by
    :func:`scale_to_fan_in`."""
    jcfg, jarch, tree = _reference_init(arch_id, dtype)
    cfg = get_config(arch_id, reduced=True)
    arch = make_arch(cfg)
    params = params_from_reference(tree, device="cpu")
    if fan_in:
        scale_to_fan_in(params, arch.param_specs(cfg))
        scaled = tree_map(lambda t: t.float().numpy(), params,
                          torch.is_tensor)
        tree = jax.tree.map(lambda a, old: a.astype(old.dtype), scaled,
                            tree)
    return Pair(jcfg, jarch, jax.tree.map(jnp.asarray, tree), cfg, arch,
                params)


def run_reference(fn, dtype: str, *args, **static):
    """``fn(*args, **static)`` of the reference: jitted (``static``
    fixed) in float32, op by op in bfloat16 (see the module docstring)."""
    if dtype == "f32":
        return jax.jit(functools.partial(fn, **static))(*args)
    with jax.disable_jit():
        return fn(*args, **static)


def inputs(cfg, b: int, s: int, seed: int):
    """Seeded tokens (B, s) and, for the VLM, patch embeddings or, for
    Whisper, ``FRAMES`` audio frames, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_patches:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def as_jax(batch: dict, dtype: str = "bf16") -> dict:
    """Floating inputs in ``dtype`` (patch embeddings are cast to the
    model's dtype inside the model; Whisper's frames must come in it)."""
    return {k: jnp.asarray(v, DTYPES[dtype][0] if v.dtype.kind == "f"
                           else None) for k, v in batch.items()}


def as_torch(batch: dict, dtype: str = "bf16") -> dict:
    return {k: (torch.from_numpy(v).to(DTYPES[dtype][1])
                if v.dtype.kind == "f" else torch.from_numpy(v))
            for k, v in batch.items()}


def max_err(jx, tx) -> float:
    return float(np.max(np.abs(np.asarray(jx, np.float32)
                               - tx.float().numpy())))


def model_gaps(arch_id: str, dtype: str, b: int = 2, s: int = 12,
               seed: int = 1, max_len: int = 20,
               fan_in: bool = False) -> dict:
    """Prefill over ``s`` seeded tokens, one decode step and the loss
    over the prompt, in both packages from the same parameters (``pair``'s
    ``fan_in``); the largest gaps of the prefill and decode logits and of
    the loss."""
    p = pair(arch_id, dtype, fan_in)
    full = inputs(p.cfg, b, s + 1, seed=seed)
    prompt = dict(full, tokens=full["tokens"][:, :s])
    nxt = full["tokens"][:, s:]
    fdt = dtype if arch_id in OTHER_IDS else "bf16"
    jprompt, tprompt = as_jax(prompt, fdt), as_torch(prompt, fdt)
    jst, jlen, jpre = run_reference(p.jarch.prefill, dtype, p.jparams,
                                    jprompt, cfg=p.jcfg, ctx=JCTX,
                                    max_len=max_len)
    _, _, jdec = run_reference(p.jarch.decode, dtype, p.jparams, jst, jlen,
                               jnp.asarray(nxt), cfg=p.jcfg, ctx=JCTX)
    jloss, jmet = run_reference(p.jarch.loss, dtype, p.jparams, jprompt,
                                cfg=p.jcfg, ctx=JCTX)
    with torch.inference_mode():
        st, length, pre = p.arch.prefill(p.params, tprompt, p.cfg, CTX,
                                         max_len=max_len)
        _, _, dec = p.arch.decode(p.params, st, length,
                                  torch.from_numpy(nxt), p.cfg, CTX)
        loss, met = p.arch.loss(p.params, tprompt, p.cfg, CTX)
    assert length == int(jlen) and pre.shape == jpre.shape
    assert dec.shape == jdec.shape
    gaps = {"prefill": max_err(jpre, pre), "decode": max_err(jdec, dec),
            "loss": abs(float(jloss) - float(loss))}
    if "aux" in jmet:
        gaps["aux"] = abs(float(jmet["aux"]) - float(met["aux"]))
    return gaps


@contextlib.contextmanager
def f32_caches():
    """Within the block, both packages keep every bfloat16 cache in
    float32: the attention K/V (``make_cache``'s default dtype, which
    zamba2's and Whisper's states take) and Mamba2's conv state."""
    import repro.models.attention as jattn
    import repro.models.zamba2 as jzamba
    import repro_torch.models.attention as tattn
    import repro_torch.models.zamba2 as tzamba
    saved = (jattn.make_cache.__defaults__, tattn.make_cache.__defaults__,
             jzamba.mamba_state_init, tzamba.mamba_state_init)
    j_init, t_init = saved[2], saved[3]

    def j_state(cfg, batch):
        st = j_init(cfg, batch)
        return dict(st, conv=st["conv"].astype(jnp.float32))

    def t_state(cfg, batch, device=None):
        st = t_init(cfg, batch, device)
        return dict(st, conv=st["conv"].float())

    jattn.make_cache.__defaults__ = (jnp.float32,)
    tattn.make_cache.__defaults__ = (torch.float32, None)
    jzamba.mamba_state_init, tzamba.mamba_state_init = j_state, t_state
    try:
        yield
    finally:
        (jattn.make_cache.__defaults__, tattn.make_cache.__defaults__,
         jzamba.mamba_state_init, tzamba.mamba_state_init) = saved


def reference_generate(jserve, p, jbatch: dict, dtype: str, n_tokens: int,
                       max_len: int = 32):
    """The reference engine's greedy tokens (B, n_tokens) and the logits
    it sampled from (B, n_tokens, V), jitted in float32 and op by op in
    bfloat16."""
    eng = jserve.ServeEngine(p.jarch, p.jparams, max_len=max_len)
    seen = []
    sample = eng._sample

    def record(logits, temperature, key):
        seen.append(np.asarray(logits, np.float32))
        return sample(logits, temperature, key)

    eng._sample = record
    if dtype == "bf16":
        with jax.disable_jit():
            toks = eng.generate(jbatch, n_tokens)
    else:
        toks = eng.generate(jbatch, n_tokens)
    return np.asarray(toks), np.stack(seen, axis=1)


def tokens_held(got, want, logits, tol: float) -> int:
    """Holds each row's tokens equal up to its first step where the
    reference's top-2 logit gap is at most ``2 * tol`` (with random
    weights two logits can tie to within rounding, and the packages may
    then pick different tokens, after which their sequences part), and
    returns the number of steps so held over all rows."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    n_tokens = want.shape[1]
    held = 0
    for row in range(want.shape[0]):
        n = int(np.argmin(clear[row])) if not clear[row].all() else n_tokens
        assert got[row, :n].tolist() == want[row, :n].tolist(), (row, n)
        held += n
    return held


# --- one training step in both packages (tests/test_torch_train*.py) ---
# the first moment after one step from fresh state is m = (1 - b1) *
# clip * g: the grads, compared leaf by leaf.  Each leaf is held within
# ``rtol`` of its largest entry plus TRAIN_FLOOR of the tree's largest:
# the floor covers leaves whose gradient is zero up to rounding (the
# sLSTM's input-gate bias, whose exact gradient nearly cancels through
# the stabilizer: 7e-10 against 54 elsewhere)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)
TRAIN_FLOOR = 1e-8


def _moments(tree, jax_tree: bool):
    leaves = (jax.tree.leaves(tree) if jax_tree
              else list(tree_leaves(tree, torch.is_tensor)))
    return [np.asarray(x, np.float32) if jax_tree else x.float().numpy()
            for x in leaves]


def _assert_leaves_close(want, got, rtol):
    assert len(want) == len(got)
    floor = TRAIN_FLOOR * max(float(np.abs(w).max()) for w in want)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        tol = rtol * float(np.abs(w).max()) + floor
        assert float(np.abs(w - g).max()) <= tol


def one_step(arch_id, fan_in, accum=1, rows=2, seq=16, seed=3):
    """The reference's jitted step and the port's from the same params
    and batch; returns ((metrics, state) of the reference, of the
    port)."""
    p = pair(arch_id, "f32", fan_in)
    jcfg = dataclasses.replace(p.jcfg, accum_steps=accum)
    cfg = dataclasses.replace(p.cfg, accum_steps=accum)
    jarch, arch = jmake_arch(jcfg), make_arch(cfg)
    batch = inputs(cfg, rows, seq, seed)
    jopt, opt = JAdamWConfig(**TRAIN_OPT), AdamWConfig(**TRAIN_OPT)
    jstep = jax.jit(jmake_train_step(jarch, jopt, JCTX))
    _, jstate, jmet = jstep(p.jparams, jinit_opt_state(p.jparams, jopt),
                            as_jax(batch, "f32"))
    step = make_train_step(arch, opt, CTX)
    _, state, met = step(p.params, init_opt_state(p.params, opt),
                         as_torch(batch, "f32"))
    return (jmet, jstate), (met, state)


def assert_step_matches(ref, port, rtol, metric_rtol=1e-5):
    (jmet, jstate), (met, state) = ref, port
    assert set(met) == set(jmet)
    for k in ("loss_total", "loss", "grad_norm", "lr"):
        assert float(met[k]) == pytest.approx(float(jmet[k]),
                                              rel=metric_rtol), k
    assert float(jmet["grad_norm"]) > 1.0       # the clip is active
    assert int(state["step"]) == int(jstate["step"]) == 1
    for key in ("m", "v"):
        _assert_leaves_close(_moments(jstate[key], True),
                             _moments(state[key], False), rtol)
