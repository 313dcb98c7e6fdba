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
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import make_arch as jmake_arch
from repro.models.common import init_params as jinit_params
from repro.sharding import ShardCtx as JShardCtx
from repro_torch import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import make_arch
from repro_torch.sharding import ShardCtx

TRANSFORMER_IDS = ("qwen3-14b", "yi-9b", "gemma2-27b", "nemotron-4-340b",
                   "internvl2-76b", "olmoe-1b-7b", "qwen2-moe-a2.7b")
OTHER_IDS = ("zamba2-7b", "xlstm-125m", "whisper-tiny")
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


@dataclasses.dataclass
class Pair:
    jcfg: object
    jarch: object
    jparams: dict
    cfg: object
    arch: object
    params: dict


@functools.lru_cache(maxsize=None)
def _reference_init(arch_id: str, dtype: str):
    jcfg = jget_config(arch_id, reduced=True)
    jarch = jmake_arch(jcfg)
    jp = jinit_params(jax.random.PRNGKey(0), jarch.param_specs(jcfg))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, jarch, jax.tree.map(np.asarray, jp)


def pair(arch_id: str, dtype: str = "bf16") -> Pair:
    """Both packages' reduced ``arch_id`` with the same parameters."""
    jcfg, jarch, tree = _reference_init(arch_id, dtype)
    cfg = get_config(arch_id, reduced=True)
    return Pair(jcfg, jarch, jax.tree.map(jnp.asarray, tree), cfg,
                make_arch(cfg), params_from_reference(tree, device="cpu"))


def run_reference(fn, dtype: str, *args, **static):
    """``fn(*args, **static)`` of the reference: jitted (``static``
    fixed) in float32, op by op in bfloat16 (see the module docstring)."""
    if dtype == "f32":
        return jax.jit(functools.partial(fn, **static))(*args)
    with jax.disable_jit():
        return fn(*args, **static)


def inputs(cfg, b: int, s: int, seed: int):
    """Seeded tokens (B, s) and, for the VLM, patch embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_patches:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype.kind == "f" else None)
            for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: (torch.from_numpy(v).to(torch.bfloat16) if v.dtype.kind == "f"
                else torch.from_numpy(v)) for k, v in batch.items()}


def max_err(jx, tx) -> float:
    return float(np.max(np.abs(np.asarray(jx, np.float32)
                               - tx.float().numpy())))
