"""Attention: GQA, rope, qk-norm, softcap, sliding window, KV cache.

Two implementations behind one interface, as in the reference:

* ``dense``     — full (Sq, Skv) score matrix; small shapes and decode.
* ``blockwise`` — flash-style: a loop over query tiles and, per query
                  tile, over the KV tiles its causal and window masks
                  can reach, with a running (m, l, acc).  The banded
                  case is the stencil tiling of the sliding-window
                  kernel, in plain PyTorch.

All score math in float32.  Positions are host integers, so the KV tile
range is static in decode as well; the tiles it skips are wholly masked
and would add exactly nothing.

The KV cache is bfloat16 whatever the parameters' dtype, and prefill
attends over the cache after K/V are written into it, so K/V are rounded
to bfloat16 on the cached path even in a float32 run.  Cross-attention
(``kv_x``, whisper's decoder) takes K/V from the source without rope,
numbers keys from 0, and reads a cache of the source's K/V as it is.

On a mesh the tensors are DTensors.  The cache is written block by block
(:func:`_write_cache`: each rank writes the positions its block holds),
since a slice of a sharded dim has no in-place DTensor form.  With
``decode_seq_shard`` a one-token decode step is flash-decoding over a
KV cache whose sequence is sharded over ``model``
(:func:`_flash_decode_seqsharded`, the reference's ``shard_map`` body on
explicit local tensors).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..sharding import (ShardCtx, _mesh_axes, as_dtensor, axis_names,
                        axis_size, block_start, from_local, is_device_mesh,
                        is_dtensor, placements, whole_along)
from .common import PSpec, rms_norm, rope, softcap as _softcap

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qk_norm: bool = False
    softcap: float | None = None
    window: int | None = None          # None = full causal
    causal: bool = True                # False for encoder self-attention
    rope_theta: float | None = 10000.0 # None = no rope (e.g. whisper)
    scale: float | None = None         # default 1/sqrt(d_head)
    block_q: int = 512
    block_k: int = 1024
    impl: str = "auto"                 # auto|dense|blockwise
    decode_seq_shard: bool = False     # flash-decode: KV seq over TP group
    fuse_qkv: bool = False             # one fused qkv projection

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv


def attn_param_specs(c: AttnCfg) -> dict[str, PSpec]:
    if c.fuse_qkv:
        p = {
            "wqkv": PSpec((c.d_model, c.n_heads + 2 * c.n_kv, c.d_head),
                          ("fsdp", "tp", None)),
            "wo": PSpec((c.n_heads, c.d_head, c.d_model),
                        ("tp", None, "fsdp")),
        }
    else:
        p = {
            "wq": PSpec((c.d_model, c.n_heads, c.d_head),
                        ("fsdp", "tp", None)),
            "wk": PSpec((c.d_model, c.n_kv, c.d_head), ("fsdp", "tp", None)),
            "wv": PSpec((c.d_model, c.n_kv, c.d_head), ("fsdp", "tp", None)),
            "wo": PSpec((c.n_heads, c.d_head, c.d_model),
                        ("tp", None, "fsdp")),
        }
    if c.qk_norm:
        p["q_norm"] = PSpec((c.d_head,), (None,), init="ones")
        p["k_norm"] = PSpec((c.d_head,), (None,), init="ones")
    return p


def _mask(q_pos, k_pos, c: AttnCfg, kv_len=None):
    """(Sq, Skv) boolean validity from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    valid = kp >= 0
    if c.causal:
        valid = valid & (kp <= qp)
    if c.window is not None:
        valid = valid & (kp > qp - c.window)
    if kv_len is not None:
        valid = valid & (kp < kv_len)
    return valid


def _scores(q, k, c: AttnCfg):
    """(B, Hkv, G, Sq, Skv) float32 scores, scaled and softcapped.
    q: (B, Hkv, G, Sq, D) float32; k: (B, Hkv, Skv, D) float32."""
    scale = c.scale or 1.0 / math.sqrt(c.d_head)
    s = torch.matmul(q, k.transpose(-1, -2)[:, :, None]) * scale
    return _softcap(s, c.softcap)


def _sdpa_dense(q, k, v, q_pos, k_pos, c: AttnCfg, kv_len=None):
    # q: (B, Hkv, G, Sq, D); k/v: (B, Hkv, Skv, D)
    s = _scores(q.float(), k.float(), c)
    valid = _mask(q_pos, k_pos, c, kv_len)        # (Sq, Skv)
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()[:, :, None]).to(q.dtype)


def _sdpa_blockwise(q, k, v, q_pos0: int, c: AttnCfg, kv_len=None):
    """Flash-style attention.  q: (B,Hkv,G,Sq,D); k/v: (B,Hkv,Skv,D);
    ``q_pos0``: the absolute position of q[..., 0, :]."""
    b, h, g, sq, d = q.shape
    skv = k.shape[2]
    bq = min(c.block_q, sq)
    bk = min(c.block_k, skv)
    n_q = -(-sq // bq)
    n_k = -(-skv // bk)
    if n_k * bk > skv and kv_len is None:
        kv_len = skv
    q = F.pad(q, (0, 0, 0, n_q * bq - sq))
    dev = q.device

    def kv_tile(t, ki):                # zero-padded past skv
        blk = t[:, :, ki * bk:(ki + 1) * bk].float()
        return F.pad(blk, (0, 0, 0, bk - blk.shape[2]))

    outs = []
    for qi in range(n_q):
        qblk = q[:, :, :, qi * bq:(qi + 1) * bq].float()
        # the KV tile range this query tile's masks can reach
        q_lo = q_pos0 + qi * bq
        q_hi = q_lo + bq - 1
        hi = n_k if not c.causal else min(n_k, (q_hi // bk) + 1)
        lo = 0
        if c.window is not None:
            lo = max(0, (q_lo - c.window + 1) // bk)
        qpos = q_lo + torch.arange(bq, device=dev)

        m = torch.full((b, h, g, bq), NEG_INF, device=dev)
        l = torch.zeros((b, h, g, bq), device=dev)
        acc = torch.zeros((b, h, g, bq, d), device=dev)
        for ki in range(lo, hi):
            s = _scores(qblk, kv_tile(k, ki), c)
            kpos = ki * bk + torch.arange(bk, device=dev)
            valid = (kpos >= 0)[None, :]
            if c.causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            if c.window is not None:
                valid = valid & (kpos[None, :] > qpos[:, None] - c.window)
            if kv_len is not None:
                valid = valid & (kpos < kv_len)[None, :]
            s = torch.where(valid[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + torch.sum(p, dim=-1)
            acc = (acc * corr[..., None]
                   + torch.matmul(p, kv_tile(v, ki)[:, :, None]))
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    return out[:, :, :, :sq].to(q.dtype)


def _flash_decode_seqsharded(q, k, v, kv_len: int, c: AttnCfg,
                             ctx: ShardCtx):
    """Decode attention with the KV cache sequence-sharded over the TP
    (``model``) axis: flash-decoding.  Each rank reduces its KV block with
    a local softmax; the partials combine with a MAX all-reduce of ``m``
    and SUM all-reduces of ``l`` and ``p·V`` over ``model``, in float32
    (payloads of (B, H, D) per rank against reading a replicated cache).

    q: (B, H, 1, D), replicated over ``model``; k/v: (B, Hkv, S, D)
    with S sharded over ``model``.  Returns (B, H, 1, D), the reference's
    ``shard_map`` body on local tensors.
    """
    import torch.distributed as dist
    mesh = ctx.cmesh
    dp = _mesh_axes(mesh, "dp")
    scale = c.scale or 1.0 / math.sqrt(c.d_head)
    b = q.shape[0]
    dp_ok = b % math.prod(axis_size(mesh, a) for a in dp) == 0
    bax = dp if dp_ok else None
    q_pl = placements(mesh, (bax, None, None, None))
    kv_pl = placements(mesh, (bax, None, "model", None))
    q_ = as_dtensor(q, mesh).redistribute(mesh, q_pl).to_local()
    q_ = q_.reshape(q_.shape[0], c.n_kv, c.group, 1, c.d_head)
    k_ = as_dtensor(k, mesh).redistribute(mesh, kv_pl).to_local()
    v_ = as_dtensor(v, mesh).redistribute(mesh, kv_pl).to_local()
    group = mesh.get_group("model")
    i = mesh.get_local_rank("model")
    s_loc = k_.shape[2]
    # this block's first key: i * s_loc where the model axis divides S
    lo = i * -(-k.shape[2] // axis_size(mesh, "model"))
    kpos = lo + torch.arange(s_loc, device=k_.device)
    s = _scores(q_.float(), k_.float(), c)
    valid = kpos < kv_len
    if c.window is not None:
        valid = valid & (kpos > (kv_len - 1) - c.window)
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    dist.all_reduce(l, group=group)
    acc = torch.matmul(p, v_.float()[:, :, None])
    dist.all_reduce(acc, group=group)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q_.dtype)
    return from_local(out.reshape(out.shape[0], c.n_heads, 1, c.d_head),
                      mesh, q_pl)


def _write_cache(buf, new, idx: int) -> None:
    """buf[:, :, idx:idx+S] = new, in place.  On a mesh each rank writes
    the positions of its block of ``buf`` (``new`` moved to ``buf``'s
    placements with the sequence dim whole)."""
    s = new.shape[2]
    if not is_dtensor(buf):
        buf[:, :, idx:idx + s] = new.to(buf.dtype)
        return
    want = whole_along(buf, 2).placements      # buf's, the sequence whole
    src = as_dtensor(new, buf.device_mesh).redistribute(
        buf.device_mesh, want).to_local()
    local = buf.to_local()
    lo = block_start(buf, 2)
    a, z = max(idx, lo), min(idx + s, lo + local.shape[2])
    if a < z:
        local[:, :, a - lo:z - lo] = src[:, :, a - idx:z - idx].to(
            local.dtype)


def make_cache(c: AttnCfg, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed K/V of ``max_len`` positions on ``device`` (``None``: the
    card; raises where CUDA is missing)."""
    dev = resolve_device(device)
    shape = (batch, c.n_kv, max_len, c.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _core(q, k, v, qpos, pos0: int, c: AttnCfg, self_uncached: bool,
          kv_len):
    """The attention of (B, H, Sq, D) queries over (B, Hkv, Skv, D) keys
    and values, (B, H, Sq, D) out.  Keys are numbered from ``pos0`` for
    self-attention without a cache, from 0 otherwise."""
    b, _, s, d = q.shape
    qg = q.reshape(b, k.shape[1], -1, s, d)
    skv = k.shape[2]
    impl = c.impl
    if impl == "auto":
        impl = "dense" if (s * skv <= 512 * 512) else "blockwise"
    if impl == "dense":
        kpos = torch.arange(skv, device=q.device)
        if self_uncached:
            kpos = pos0 + kpos
        o = _sdpa_dense(qg, k, v, qpos, kpos, c, kv_len)
    else:
        o = _sdpa_blockwise(qg, k, v, pos0, c, kv_len)
    return o.reshape(b, -1, s, d)


def _core_on_mesh(q, k, v, qpos, pos0: int, c: AttnCfg, ctx: ShardCtx,
                  self_uncached: bool, kv_len):
    """:func:`_core` on each rank's block of (batch, KV heads), as a
    ``shard_map`` would run it: the batch over ``dp`` and the KV heads
    (with their query heads) over ``model`` where those divide them, the
    sequence whole; the block's result is the DTensor's local part.
    Every step of the core is local to a (batch, head) pair, and on a
    (2, 2, 2) mesh DTensor's strategy search for its products alone
    takes minutes."""
    mesh = ctx.cmesh
    b = q.shape[0]
    dp = _mesh_axes(mesh, "dp")
    bax = dp if b % math.prod(axis_size(mesh, a) for a in dp) == 0 else None
    hax = "model" if c.n_kv % axis_size(mesh, "model") == 0 else None
    pl = placements(mesh, (bax, hax, None, None))
    o = _core(*(as_dtensor(t, mesh).redistribute(mesh, pl).to_local()
                for t in (q, k, v)), qpos, pos0, c, self_uncached, kv_len)
    return from_local(o, mesh, pl)


def _heads(x, w):
    """einsum("bsd,dhk->bhsk", x, w) as one product."""
    d, nh, dh = w.shape
    return (x @ w.reshape(d, nh * dh)).unflatten(-1, (nh, dh)).transpose(1, 2)


def attention(
    p: dict,
    x: torch.Tensor,              # (B, S, D)
    c: AttnCfg,
    ctx: ShardCtx,
    pos0: int = 0,                # absolute position of x[:, 0]
    cache: dict | None = None,    # KV cache, written in place
    cache_len: int | None = None,  # filled length of cache
    kv_x: torch.Tensor | None = None,   # cross-attention source
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention over ``x``, or cross-attention from ``x`` to
    ``kv_x``.  With ``kv_x`` and a cache, the cache holds the source's
    K/V already and is read as it is (``kv_x``'s values are not used)."""
    b, s, _ = x.shape
    cross_cached = kv_x is not None and cache is not None
    if c.fuse_qkv and kv_x is None:
        qkv = _heads(x, p["wqkv"])
        q = qkv[:, :c.n_heads]
        k = qkv[:, c.n_heads:c.n_heads + c.n_kv]
        v = qkv[:, c.n_heads + c.n_kv:]
    else:
        q = _heads(x, p["wq"])
        if cross_cached:
            k, v = cache["k"], cache["v"]
        else:
            src = x if kv_x is None else kv_x
            k, v = _heads(src, p["wk"]), _heads(src, p["wv"])

    if c.qk_norm:                      # the default eps, not cfg.norm_eps
        q = rms_norm(q, p["q_norm"])
        if not cross_cached:           # a cached source was normed before
            k = rms_norm(k, p["k_norm"])

    qpos = pos0 + torch.arange(s, device=x.device)
    if c.rope_theta is not None:
        q = rope(q, qpos[None, None, :], c.rope_theta)
        if kv_x is None:
            k = rope(k, qpos[None, None, :], c.rope_theta)

    q = ctx.constrain(q, "dp", "tp", None, None)
    k = ctx.constrain(k, "dp", "tp", None, None)
    v = ctx.constrain(v, "dp", "tp", None, None)

    kv_len = None
    if cache is not None and kv_x is None:
        idx = cache_len if cache_len is not None else 0
        _write_cache(cache["k"], k, idx)
        _write_cache(cache["v"], v, idx)
        k, v = cache["k"], cache["v"]
        kv_len = idx + s

    hd = c.n_heads * c.d_head          # wo: (n_heads, d_head, d_out)
    if (c.decode_seq_shard and cache is not None and s == 1 and kv_x is None
            and is_device_mesh(ctx.mesh)
            and "model" in axis_names(ctx.mesh)):
        o = _flash_decode_seqsharded(q, k, v, kv_len, c, ctx)
    elif is_dtensor(q):
        o = _core_on_mesh(q, k, v, qpos, pos0, c, ctx, cache is None
                          and kv_x is None, kv_len)
    else:
        o = _core(q, k, v, qpos, pos0, c, cache is None and kv_x is None,
                  kv_len)
    o = o.transpose(1, 2)
    y = o.reshape(b, s, hd) @ p["wo"].reshape(hd, -1)
    return ctx.constrain(y, "dp", None, None), cache
