"""Generic decoder-only LM covering the dense / MoE / VLM-backbone archs.

Layers are stacked per *pattern unit*, as in the reference, and the
port loops over the units in Python on views of the stacked tensors
(with ``scan_layers`` either way: the reference's ``lax.scan`` runs the
same unit body in the same order).  With ``cfg.remat`` each unit's body
is recomputed in the backward pass (``torch.utils.checkpoint``, as the
reference wraps it in ``jax.checkpoint``).  Heterogeneous stacks (gemma2
local/global alternation) unroll inside the unit.  KV caches are updated
in place, which stands in for the reference's donated carries.

On one device or on a mesh (``ctx``): the residual stream is constrained
after the embedding and after each block (:func:`res_constrain`; with
``seq_shard`` its sequence dim shards over ``model``, Megatron-SP), and
the caches prefill builds are placed by :func:`cache_specs`.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..sharding import ShardCtx, block_start, from_local, is_dtensor
from .attention import AttnCfg, attention, attn_param_specs, make_cache
from .common import (PSpec, cross_entropy, place_state, remat, rms_norm,
                     softcap, stack_specs, tree_map)
from .config import ModelConfig
from .mlp import mlp, mlp_param_specs
from .moe import moe_ffn, moe_param_specs


def attn_cfg_for(cfg: ModelConfig, kind: str) -> AttnCfg:
    return AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, qk_norm=cfg.qk_norm, softcap=cfg.attn_softcap,
        window=cfg.window if kind == "local" else None,
        causal=True, rope_theta=cfg.rope_theta, scale=cfg.attn_scale,
        block_q=cfg.block_q, block_k=cfg.block_k, impl=cfg.attn_impl,
        decode_seq_shard=cfg.decode_kv_seq_shard, fuse_qkv=cfg.fuse_qkv)


def res_constrain(h, cfg: ModelConfig, ctx: ShardCtx):
    """Residual-stream sharding: batch over dp, seq over TP (Megatron-SP)."""
    if cfg.seq_shard:
        return ctx.constrain(h, "dp", "seq", None)
    return ctx.constrain(h, "dp", None, None)


def _unit_param_specs(cfg: ModelConfig) -> dict[str, Any]:
    specs: dict[str, Any] = {}
    for i, kind in enumerate(cfg.layer_pattern):
        specs[f"attn_{i}"] = attn_param_specs(attn_cfg_for(cfg, kind))
        if cfg.moe is not None:
            specs[f"ffn_{i}"] = moe_param_specs(cfg.d_model, cfg.moe)
        else:
            specs[f"ffn_{i}"] = mlp_param_specs(cfg.d_model, cfg.d_ff,
                                                cfg.act)
        specs[f"ln_attn_{i}"] = PSpec((cfg.d_model,), (None,), init="ones")
        specs[f"ln_ffn_{i}"] = PSpec((cfg.d_model,), (None,), init="ones")
        if cfg.post_norm:
            specs[f"ln_attn_post_{i}"] = PSpec((cfg.d_model,), (None,),
                                               init="ones")
            specs[f"ln_ffn_post_{i}"] = PSpec((cfg.d_model,), (None,),
                                              init="ones")
    return specs


def lm_param_specs(cfg: ModelConfig) -> dict[str, Any]:
    specs: dict[str, Any] = {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("tp", "fsdp"),
                       init="embed"),
        "ln_final": PSpec((cfg.d_model,), (None,), init="ones"),
        "units": stack_specs(_unit_param_specs(cfg), cfg.n_units),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((cfg.d_model, cfg.vocab), ("fsdp", "tp"))
    return specs


def _norm(x, scale, cfg: ModelConfig):
    return rms_norm(x, scale, cfg.norm_eps, plus_one=cfg.norm_plus_one)


def _unit_body(cfg: ModelConfig, ctx: ShardCtx, up: dict, h: torch.Tensor,
               caches: dict | None, pos0: int, cache_len: int | None):
    """One pattern unit; returns (h, aux_loss).  ``caches`` (this unit's
    views of the stacked caches) are written in place.  On a mesh the
    unit's weights are gathered over ``dp`` here (FSDP) and each block's
    input over the sequence (Megatron-SP's all-gather on entry)."""
    up = ctx.gather_weights(up)
    aux = torch.zeros((), device=h.device)
    for i, kind in enumerate(cfg.layer_pattern):
        c = attn_cfg_for(cfg, kind)
        a_in = ctx.constrain(_norm(h, up[f"ln_attn_{i}"], cfg),
                             "dp", None, None)
        cache_i = caches[f"kv_{i}"] if caches is not None else None
        a_out, _ = attention(up[f"attn_{i}"], a_in, c, ctx, pos0=pos0,
                             cache=cache_i, cache_len=cache_len)
        if cfg.post_norm:
            a_out = _norm(a_out, up[f"ln_attn_post_{i}"], cfg)
        h = res_constrain(h + a_out, cfg, ctx)

        f_in = ctx.constrain(_norm(h, up[f"ln_ffn_{i}"], cfg),
                             "dp", None, None)
        if cfg.moe is not None:
            f_out, moe_aux = moe_ffn(up[f"ffn_{i}"], f_in, cfg.moe, ctx)
            aux = aux + moe_aux["aux_total"]
        else:
            f_out = mlp(up[f"ffn_{i}"], f_in, cfg.act, ctx)
        if cfg.post_norm:
            f_out = _norm(f_out, up[f"ln_ffn_post_{i}"], cfg)
        h = res_constrain(h + f_out, cfg, ctx)
    return h, aux


def lm_apply(params: dict, h: torch.Tensor, cfg: ModelConfig,
             ctx: ShardCtx, pos0: int = 0, caches=None,
             cache_len: int | None = None):
    """Run the layer stack on embedded inputs h: (B, S, D); returns
    (h, caches, aux).  ``caches`` (stacked per unit) are written in
    place and returned."""
    aux = torch.zeros((), device=h.device)
    for r in range(cfg.n_units):
        up = tree_map(lambda t: t[r], params["units"], torch.is_tensor)
        uc = (tree_map(lambda t: t[r], caches, torch.is_tensor)
              if caches is not None else None)
        h, a = remat(cfg.remat, _unit_body, cfg, ctx, up, h, uc, pos0,
                     cache_len)
        aux = aux + a
    h = _norm(h, ctx.gather_weights(params["ln_final"]), cfg)
    return h, (caches if caches is not None else {}), aux


def lookup(table: torch.Tensor, tokens: torch.Tensor, ctx: ShardCtx):
    """``table[tokens]``.  On a mesh (the table's rows sharded over the
    vocabulary, its model dim whole) it is Megatron's vocab-parallel
    lookup: each rank looks up the tokens its rows hold, zeros for the
    rest, and a SUM all-reduce over the rows' mesh dims joins the parts
    (its backward the identity); a gather from a vocabulary-sharded table
    has no DTensor form that runs (the reference's fails at this op under
    jax 0.9), and gathering the whole table each call would move it every
    decode step."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tok = ctx.constrain(tokens, "dp", *([None] * (tokens.ndim - 1)))
    # this rank's rows, used on its own tokens: their grad is its part of
    # a sum over the tokens' (dp) ranks
    rows = table.to_local(grad_placements=[
        Partial() if isinstance(tp, Shard) else pl
        for pl, tp in zip(table.placements, tok.placements)])
    lo = block_start(table, 0)
    local = tok.to_local()
    hit = (local >= lo) & (local < lo + rows.shape[0])
    idx = torch.where(hit, local - lo, torch.zeros_like(local))
    part = rows[idx] * hit[..., None].to(rows.dtype)
    dims = [j for j, pl in enumerate(table.placements)
            if isinstance(pl, Shard) and pl.dim == 0]
    for j in dims:
        part = _SumOver.apply(part, mesh.get_group(j))
    places = tuple(Replicate() if j in dims else tp
                   for j, tp in enumerate(tok.placements))
    return from_local(part, mesh, places,
                      tuple(tokens.shape) + (table.shape[1],))


class _SumOver(torch.autograd.Function):
    """A SUM all-reduce over ``group`` forward; the identity backward
    (each rank's part of a sum gets the sum's grad)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
          ctx: ShardCtx) -> torch.Tensor:
    h = lookup(ctx.gather_weights(params["embed"]), tokens, ctx)
    if cfg.embed_scale:             # sqrt(d) rounded to h's dtype first
        h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype))
    return res_constrain(h, cfg, ctx)


def unembed(params: dict, h: torch.Tensor, cfg: ModelConfig,
            ctx: ShardCtx) -> torch.Tensor:
    """Logits in the params' dtype, then float32 and the final softcap."""
    h = ctx.constrain(h, "dp", None, None)
    if cfg.tie_embeddings:
        logits = h @ ctx.gather_weights(params["embed"]).T
    else:
        logits = h @ ctx.gather_weights(params["lm_head"])
    logits = ctx.constrain(logits, "dp", None, "tp")
    return softcap(logits.float(), cfg.final_softcap)


def _assemble_inputs(params, batch, cfg, ctx):
    """tokens (+ optional VLM patch embeds) -> h0."""
    h = embed(params, batch["tokens"], cfg, ctx)
    if cfg.n_patches and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)     # (B, P, D) stub frontend
        h = torch.cat([pe, h], dim=1)
    return h


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            ctx: ShardCtx) -> tuple[torch.Tensor, dict]:
    """The training loss (next-token CE plus the MoE aux losses) and its
    parts; autograd differentiates it."""
    h = _assemble_inputs(params, batch, cfg, ctx)
    h, _, aux = lm_apply(params, h, cfg, ctx)
    tokens = batch["tokens"]
    p = cfg.n_patches if (cfg.n_patches and "patch_embeds" in batch) else 0
    # positions p..p+S-2 predict tokens 1..S-1
    logits = unembed(params, h[:, p:-1], cfg, ctx)
    loss = cross_entropy(logits, tokens[:, 1:])
    total = loss + aux
    return total, {"loss": loss, "aux": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    """Stacked (per unit) KV caches, bfloat16 by default, on ``device``
    (``None``: the card; raises where CUDA is missing)."""
    caches = {}
    for i, kind in enumerate(cfg.layer_pattern):
        c = attn_cfg_for(cfg, kind)
        one = make_cache(c, batch, max_len, dtype, device)
        caches[f"kv_{i}"] = {
            k: t.new_zeros((cfg.n_units,) + t.shape) for k, t in one.items()}
    return caches


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """PSpec tree for the KV caches, with the reference's logical axes."""
    unit = {}
    for i, _ in enumerate(cfg.layer_pattern):
        shape = (cfg.n_units, batch, cfg.n_kv, max_len, cfg.d_head)
        batch_ax = "dp" if batch > 1 else None
        if cfg.decode_kv_seq_shard:
            head_ax, seq_ax = None, "tp"
        else:
            head_ax = "tp"
            seq_ax = "sp" if batch == 1 else None
        unit[f"kv_{i}"] = {
            "k": PSpec(shape, (None, batch_ax, head_ax, seq_ax, None)),
            "v": PSpec(shape, (None, batch_ax, head_ax, seq_ax, None)),
        }
    return unit


def _device(params) -> torch.device:
    return params["embed"].device


def lm_prefill(params: dict, batch: dict, cfg: ModelConfig, ctx: ShardCtx,
               max_len: int | None = None):
    """Forward over a prompt, building KV caches; returns
    (caches, length, last logits)."""
    b, s = batch["tokens"].shape
    p = cfg.n_patches if (cfg.n_patches and "patch_embeds" in batch) else 0
    max_len = max_len or (s + p)
    caches = place_state(init_caches(cfg, b, max_len, device=_device(params)),
                         cache_specs(cfg, b, max_len), ctx)
    h = _assemble_inputs(params, batch, cfg, ctx)
    h, caches, _ = lm_apply(params, h, cfg, ctx, pos0=0, caches=caches,
                            cache_len=0)
    logits = unembed(params, h[:, -1:], cfg, ctx)
    return caches, s + p, logits


def lm_decode(params: dict, caches, cache_len: int, tokens: torch.Tensor,
              cfg: ModelConfig, ctx: ShardCtx):
    """One decode step. tokens: (B, 1) -> (caches, new_len, logits).
    The caches are updated in place."""
    h = embed(params, tokens, cfg, ctx)
    h, caches, _ = lm_apply(params, h, cfg, ctx, pos0=cache_len,
                            caches=caches, cache_len=cache_len)
    logits = unembed(params, h, cfg, ctx)
    return caches, cache_len + tokens.shape[1], logits
