"""Whisper-style encoder-decoder backbone (audio family).

As in the reference, the conv frontend is a stub: the batch carries
precomputed frame embeddings (B, T, d_model), the output the two strided
convs would produce, in the parameters' dtype.  The backbone
(bidirectional encoder, causal decoder with cross-attention) is whole:
no linear biases, LayerNorm with scale and bias, sinusoidal encoder
positions, learned decoder positions.

Decode state: per layer a bfloat16 self-attention cache and the cross
K/V of the encoder output, in its dtype, computed once at prefill.
"""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from ..sharding import ShardCtx
from .attention import (AttnCfg, _heads, attention, attn_param_specs,
                        make_cache, split_of)
from .common import (PSpec, cross_entropy, layer_norm, place_state, remat,
                     sinusoidal_positions, stack_specs, tree_map)
from .config import ModelConfig
from .mlp import mlp, mlp_param_specs
from .transformer import lookup


def _attn_cfg(cfg: ModelConfig, causal: bool) -> AttnCfg:
    return AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, causal=causal, rope_theta=None,
        block_q=cfg.block_q, block_k=cfg.block_k, impl=cfg.attn_impl,
        split_cols=True)


def _ln_specs(d: int) -> dict[str, PSpec]:
    return {"scale": PSpec((d,), (None,), init="ones"),
            "bias": PSpec((d,), (None,), init="zeros")}


def _enc_layer_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "attn": attn_param_specs(_attn_cfg(cfg, causal=False)),
        "mlp": mlp_param_specs(cfg.d_model, cfg.d_ff, "gelu"),
        "ln1": _ln_specs(cfg.d_model),
        "ln2": _ln_specs(cfg.d_model),
    }


def _dec_layer_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "self_attn": attn_param_specs(_attn_cfg(cfg, causal=True)),
        "cross_attn": attn_param_specs(_attn_cfg(cfg, causal=False)),
        "mlp": mlp_param_specs(cfg.d_model, cfg.d_ff, "gelu"),
        "ln1": _ln_specs(cfg.d_model),
        "ln2": _ln_specs(cfg.d_model),
        "ln3": _ln_specs(cfg.d_model),
    }


def whisper_param_specs(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("tp", "fsdp"),
                       init="embed"),
        "pos_dec": PSpec((cfg.max_seq, cfg.d_model), (None, None),
                         init="embed"),
        "enc_layers": stack_specs(_enc_layer_specs(cfg), cfg.encoder_layers),
        "dec_layers": stack_specs(_dec_layer_specs(cfg), cfg.n_layers),
        "ln_enc": _ln_specs(cfg.d_model),
        "ln_dec": _ln_specs(cfg.d_model),
    }


def _ln(x, p):
    return layer_norm(x, p["scale"], p["bias"])


def _layer(stacked, i):
    return tree_map(lambda t: t[i], stacked, torch.is_tensor)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           ctx: ShardCtx) -> torch.Tensor:
    b, t, d = frames.shape
    pos = sinusoidal_positions(t, d, device=frames.device).to(frames.dtype)
    h = ctx.constrain(frames + pos[None], "dp", None, None)
    c = _attn_cfg(cfg, causal=False)
    for i in range(cfg.encoder_layers):
        h = remat(cfg.remat, _enc_layer, _layer(params["enc_layers"], i), h,
                  c, ctx)
    return _ln(h, params["ln_enc"])


def _enc_layer(lp, h, c: AttnCfg, ctx: ShardCtx):
    a, _ = attention(lp["attn"], _ln(h, lp["ln1"]), c, ctx)
    h = h + a
    return h + mlp(lp["mlp"], _ln(h, lp["ln2"]), "gelu", ctx)


def decode_stack(params, h, enc_out, cfg: ModelConfig, ctx: ShardCtx,
                 pos0: int = 0, caches=None, cache_len: int | None = None):
    """Decoder layers.  caches: {"self": kv, "cross": kv} stacked per
    layer (the self caches written in place), or None (cross-attention
    to ``enc_out``)."""
    for i in range(cfg.n_layers):
        lc = _layer(caches, i) if caches is not None else None
        h = remat(cfg.remat, _dec_layer, cfg, ctx,
                  _layer(params["dec_layers"], i), lc, h, enc_out, pos0,
                  cache_len)
    return _ln(h, params["ln_dec"]), caches


def _dec_layer(cfg: ModelConfig, ctx: ShardCtx, lp, lc, h, enc_out,
               pos0: int, cache_len: int | None):
    a, _ = attention(lp["self_attn"], _ln(h, lp["ln1"]),
                     _attn_cfg(cfg, causal=True), ctx, pos0=pos0,
                     cache=None if lc is None else lc["self"],
                     cache_len=cache_len)
    h = h + a
    c_cross = _attn_cfg(cfg, causal=False)
    if lc is not None:
        # the cache holds the encoder's K/V: kv_x marks the call as
        # cross-attention and is not read
        x_attn, _ = attention(lp["cross_attn"], _ln(h, lp["ln2"]), c_cross,
                              ctx, cache=lc["cross"], kv_x=h[:, :1])
    else:
        x_attn, _ = attention(lp["cross_attn"], _ln(h, lp["ln2"]), c_cross,
                              ctx, kv_x=enc_out)
    h = h + x_attn
    return h + mlp(lp["mlp"], _ln(h, lp["ln3"]), "gelu", ctx)


def _embed_dec(params, tokens, pos0: int, cfg: ModelConfig,
               ctx: ShardCtx | None = None):
    """Token embeddings plus learned positions pos0..pos0+s-1; the start
    is clamped to [0, max_seq - s], as the reference's ``dynamic_slice``
    clamps it.  On a mesh the rows are looked up on each rank's block of
    the table (the transformer's ``lookup``): DTensor's own gather and
    its backward (``aten.index_put``) fail there on torch 2.11 and 2.13."""
    ctx = ctx or ShardCtx()
    h = lookup(params["embed"], tokens, ctx)
    s = tokens.shape[1]
    start = min(max(pos0, 0), params["pos_dec"].shape[0] - s)
    pos = params["pos_dec"][start:start + s]
    return ctx.constrain(h + pos[None].to(h.dtype), "dp", None, None)


def _logits(params, h, ctx: ShardCtx):
    h = ctx.constrain(h, "dp", None, None)
    return (h @ params["embed"].T).float()


def whisper_loss(params, batch, cfg: ModelConfig, ctx: ShardCtx):
    """The training loss; autograd differentiates it."""
    params = ctx.gather_weights(params)
    enc_out = encode(params, batch["frames"], cfg, ctx)
    tokens = batch["tokens"]
    h = _embed_dec(params, tokens, 0, cfg, ctx)
    h, _ = decode_stack(params, h, enc_out, cfg, ctx)
    logits = ctx.constrain(_logits(params, h[:, :-1], ctx),
                           "dp", None, "tp")
    loss = cross_entropy(logits, tokens[:, 1:])
    return loss, {"loss": loss}


def _cross_kv(params, enc_out, cfg: ModelConfig,
              ctx: ShardCtx | None = None):
    """Per-layer cross K/V of the encoder output, stacked, in its dtype."""
    ks, vs = [], []
    split = split_of(_attn_cfg(cfg, causal=False), ctx or ShardCtx())
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)["cross_attn"]
        ks.append(_heads(enc_out, lp["wk"], split))
        vs.append(_heads(enc_out, lp["wv"], split))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def whisper_state_specs(cfg: ModelConfig, batch: int, max_len: int):
    bax = "dp" if batch > 1 else None
    if cfg.decode_kv_seq_shard:
        head_ax, seq_ax = None, "tp"
    else:
        head_ax = "tp"
        seq_ax = "sp" if batch == 1 else None
    self_shape = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.d_head)
    cross_shape = (cfg.n_layers, batch, cfg.n_kv,
                   cfg.max_source_positions, cfg.d_head)

    def kv(shp):
        return {k: PSpec(shp, (None, bax, head_ax, seq_ax, None),
                         dtype=torch.bfloat16, init="zeros")
                for k in ("k", "v")}
    return {"self": kv(self_shape), "cross": kv(cross_shape)}


def whisper_state_init(cfg: ModelConfig, batch: int, max_len: int,
                       device=None):
    """Zeroed caches of :func:`whisper_state_specs` on ``device``
    (``None``: the card; raises where CUDA is missing)."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    whisper_state_specs(cfg, batch, max_len))


def whisper_prefill(params, batch, cfg: ModelConfig, ctx: ShardCtx,
                    max_len: int | None = None):
    """Encode the audio and run the decoder prompt, building the caches."""
    params = ctx.gather_weights(params)
    enc_out = encode(params, batch["frames"], cfg, ctx)
    tokens = batch["tokens"]
    b, s = tokens.shape
    self_c = make_cache(_attn_cfg(cfg, causal=True), b, max_len or s,
                        device=params["embed"].device)
    self_c = {k: v.new_zeros((cfg.n_layers,) + v.shape)
              for k, v in self_c.items()}
    caches = {"self": place_state(
                  self_c, whisper_state_specs(cfg, b, max_len or s)["self"],
                  ctx),
              "cross": _cross_kv(params, enc_out, cfg, ctx)}
    h = _embed_dec(params, tokens, 0, cfg, ctx)
    h, caches = decode_stack(params, h, None, cfg, ctx, pos0=0,
                             caches=caches, cache_len=0)
    return caches, s, _logits(params, h[:, -1:], ctx)


def whisper_decode(params, caches, cache_len: int, tokens, cfg: ModelConfig,
                   ctx: ShardCtx):
    params = ctx.gather_weights(params)
    h = _embed_dec(params, tokens, cache_len, cfg, ctx)
    h, caches = decode_stack(params, h, None, cfg, ctx, pos0=cache_len,
                             caches=caches, cache_len=cache_len)
    logits = ctx.constrain(_logits(params, h, ctx), "dp", None, "tp")
    return caches, cache_len + tokens.shape[1], logits
