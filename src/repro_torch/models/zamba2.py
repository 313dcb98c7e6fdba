"""Zamba2: Mamba2 backbone + a *shared* transformer block applied
periodically, with per-invocation LoRA.

Wiring, as in the reference (arXiv:2411.15242, simplified where the paper
under-specifies):
  * Mamba2 blocks grouped as units of three (81 blocks, 27 units at
    full depth); the port loops over the units in Python;
  * the shared block fires on every second unit (the odd ones: 13 of 27
    at full depth);
  * the shared block consumes concat(hidden, original embedding) (width
    2D) and projects back to D; its weights are shared across firings,
    with small per-unit LoRA adapters on q/k/v (rank ``cfg.lora_rank``),
    merged into the weights on every firing.

Decode state is stacked per unit, as the reference's: every unit holds
an SSM state per block and a KV cache, and only the firing units' caches
are written.  States and caches are updated in place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..sharding import ShardCtx, unflatten_dim
from .attention import AttnCfg, attention, make_cache
from .common import (PSpec, cross_entropy, place_state, remat, rms_norm,
                     stack_specs, tree_map)
from .config import ModelConfig
from .mamba2 import (mamba_block, mamba_param_specs, mamba_state_init,
                     mamba_state_specs)
from .mlp import gated_in
from .transformer import embed, unembed

LAYERS_PER_UNIT = 3


def shared_attn_cfg(cfg: ModelConfig) -> AttnCfg:
    return AttnCfg(
        d_model=2 * cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta,
        block_q=cfg.block_q, block_k=cfg.block_k, impl=cfg.attn_impl,
        decode_seq_shard=cfg.decode_kv_seq_shard)


def _unit_specs(cfg: ModelConfig) -> dict[str, Any]:
    d2 = 2 * cfg.d_model
    r = cfg.lora_rank
    hqd = cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv * cfg.d_head
    specs: dict[str, Any] = {}
    for i in range(LAYERS_PER_UNIT):
        specs[f"mamba_{i}"] = mamba_param_specs(cfg)
        specs[f"ln_{i}"] = PSpec((cfg.d_model,), (None,), init="ones")
    if r:
        for nm, od in (("q", hqd), ("k", kvd), ("v", kvd)):
            specs[f"lora_{nm}_a"] = PSpec((d2, r), ("fsdp", None))
            specs[f"lora_{nm}_b"] = PSpec((r, od), (None, "tp"),
                                          init="zeros")
    return specs


def _shared_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, d2 = cfg.d_model, 2 * cfg.d_model
    f = cfg.d_ff
    return {
        "ln_attn": PSpec((d2,), (None,), init="ones"),
        "wq": PSpec((d2, cfg.n_heads, cfg.d_head), ("fsdp", "tp", None)),
        "wk": PSpec((d2, cfg.n_kv, cfg.d_head), ("fsdp", "tp", None)),
        "wv": PSpec((d2, cfg.n_kv, cfg.d_head), ("fsdp", "tp", None)),
        "wo": PSpec((cfg.n_heads, cfg.d_head, d), ("tp", None, "fsdp")),
        "ln_mlp": PSpec((d2,), (None,), init="ones"),
        "w_in": PSpec((d2, 2, f), ("fsdp", None, "tp")),
        "w_out": PSpec((f, d), ("tp", "fsdp")),
    }


def zamba_param_specs(cfg: ModelConfig) -> dict[str, Any]:
    assert cfg.n_layers % LAYERS_PER_UNIT == 0
    n_units = cfg.n_layers // LAYERS_PER_UNIT
    return {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("tp", "fsdp"),
                       init="embed"),
        "ln_final": PSpec((cfg.d_model,), (None,), init="ones"),
        "units": stack_specs(_unit_specs(cfg), n_units),
        "shared": _shared_specs(cfg),
    }


def n_fires(cfg: ModelConfig) -> int:
    """Firings of the shared block per call: the odd units."""
    return (cfg.n_layers // LAYERS_PER_UNIT) // 2


def _apply_shared(cfg: ModelConfig, ctx: ShardCtx, shared: dict, up: dict,
                  h, h0, kv_cache, pos0, cache_len):
    """One firing.  The LoRA delta a @ b is formed in float32, cast to the
    base weight's dtype and added there: two roundings, every firing."""
    x2 = torch.cat([h, h0], dim=-1)
    x2n = ctx.constrain(rms_norm(x2, shared["ln_attn"], cfg.norm_eps),
                        "dp", None, None)
    p = dict(wq=shared["wq"], wk=shared["wk"], wv=shared["wv"],
             wo=shared["wo"])
    if cfg.lora_rank:
        for nm in ("q", "k", "v"):
            delta = (up[f"lora_{nm}_a"].float()
                     @ up[f"lora_{nm}_b"].float())
            base = p[f"w{nm}"]
            p[f"w{nm}"] = base + unflatten_dim(
                delta, -1, base.shape[1:]).to(base.dtype)
    a_out, _ = attention(p, x2n, shared_attn_cfg(cfg), ctx, pos0=pos0,
                         cache=kv_cache, cache_len=cache_len)
    h = h + a_out
    x2 = torch.cat([h, h0], dim=-1)
    m_in = ctx.constrain(rms_norm(x2, shared["ln_mlp"], cfg.norm_eps),
                         "dp", None, None)
    gate, up = gated_in(m_in, shared["w_in"], ctx, "dp", None, "tp")
    hh = F.silu(gate.float()).to(h.dtype) * up
    return h + ctx.constrain(hh @ shared["w_out"], "dp", None, None)


def zamba_unit(cfg: ModelConfig, ctx: ShardCtx, shared: dict, up: dict, h,
               h0, st: dict | None, fire: bool, pos0: int = 0,
               cache_len: int | None = None):
    """Three Mamba2 blocks, then the shared block if ``fire``.  ``st``
    (this unit's views of the stacked state) is written in place."""
    for i in range(LAYERS_PER_UNIT):
        x_in = rms_norm(h, up[f"ln_{i}"], cfg.norm_eps)
        m_st = st[f"ssm_{i}"] if st is not None else None
        m_out, m_new = mamba_block(up[f"mamba_{i}"], x_in, cfg, ctx,
                                   state=m_st)
        h = h + m_out
        if st is not None:
            for k, t in m_new.items():
                m_st[k].copy_(t)
    if fire:
        h = _apply_shared(cfg, ctx, shared, up, h, h0,
                          st["kv"] if st is not None else None, pos0,
                          cache_len)
    return h


def zamba_apply(params, h, cfg: ModelConfig, ctx: ShardCtx, pos0: int = 0,
                state=None, cache_len: int | None = None):
    """state: {"ssm_i": stacked mamba states, "kv": stacked KV caches}
    or None; written in place and returned."""
    h0 = h
    shared = ctx.gather_weights(params["shared"])
    for r in range(cfg.n_layers // LAYERS_PER_UNIT):
        up = ctx.gather_weights(tree_map(lambda t: t[r], params["units"],
                                         torch.is_tensor))
        st = (tree_map(lambda t: t[r], state, torch.is_tensor)
              if state is not None else None)
        h = remat(cfg.remat, zamba_unit, cfg, ctx, shared, up, h,
                  h0, st, r % 2 == 1, pos0, cache_len)
    h = rms_norm(h, ctx.gather_weights(params["ln_final"]), cfg.norm_eps)
    return h, state


def zamba_loss(params, batch, cfg: ModelConfig, ctx: ShardCtx):
    """The training loss; autograd differentiates it."""
    h = embed(params, batch["tokens"], cfg, ctx)
    h, _ = zamba_apply(params, h, cfg, ctx)
    logits = unembed(params, h[:, :-1], cfg, ctx)
    loss = cross_entropy(logits, batch["tokens"][:, 1:])
    return loss, {"loss": loss}


def zamba_state_init(cfg: ModelConfig, batch: int, max_len: int,
                     device=None):
    """Zeroed stacked state on ``device`` (``None``: the card; raises
    where CUDA is missing)."""
    n_units = cfg.n_layers // LAYERS_PER_UNIT
    unit: dict[str, Any] = {f"ssm_{i}": mamba_state_init(cfg, batch, device)
                            for i in range(LAYERS_PER_UNIT)}
    unit["kv"] = make_cache(shared_attn_cfg(cfg), batch, max_len,
                            device=device)
    return tree_map(lambda t: t.new_zeros((n_units,) + t.shape), unit,
                    torch.is_tensor)


def zamba_state_specs(cfg: ModelConfig, batch: int, max_len: int):
    n_units = cfg.n_layers // LAYERS_PER_UNIT
    unit: dict[str, Any] = {f"ssm_{i}": mamba_state_specs(cfg, batch)
                            for i in range(LAYERS_PER_UNIT)}
    batch_ax = "dp" if batch > 1 else None
    if cfg.decode_kv_seq_shard:
        head_ax, seq_ax = None, "tp"
    else:
        head_ax = "tp"
        seq_ax = "sp" if batch == 1 else None
    shape = (batch, cfg.n_kv, max_len, cfg.d_head)
    unit["kv"] = {
        "k": PSpec(shape, (batch_ax, head_ax, seq_ax, None),
                   dtype=torch.bfloat16, init="zeros"),
        "v": PSpec(shape, (batch_ax, head_ax, seq_ax, None),
                   dtype=torch.bfloat16, init="zeros"),
    }
    return stack_specs(unit, n_units)


def zamba_prefill(params, batch, cfg: ModelConfig, ctx: ShardCtx,
                  max_len: int | None = None):
    tokens = batch["tokens"]
    b, s = tokens.shape
    state = place_state(zamba_state_init(cfg, b, max_len or s,
                                         device=params["embed"].device),
                        zamba_state_specs(cfg, b, max_len or s), ctx)
    h = embed(params, tokens, cfg, ctx)
    h, state = zamba_apply(params, h, cfg, ctx, pos0=0, state=state,
                           cache_len=0)
    logits = unembed(params, h[:, -1:], cfg, ctx)
    return state, s, logits


def zamba_decode(params, state, cache_len: int, tokens, cfg: ModelConfig,
                 ctx: ShardCtx):
    """One decode step; the state is updated in place."""
    h = embed(params, tokens, cfg, ctx)
    h, state = zamba_apply(params, h, cfg, ctx, pos0=cache_len, state=state,
                           cache_len=cache_len)
    logits = unembed(params, h, cfg, ctx)
    return state, cache_len + tokens.shape[1], logits
