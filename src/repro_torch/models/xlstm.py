"""xLSTM: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar
memory, sequential scan) blocks (arXiv:2405.04517).

The chunkwise mLSTM is another block-contiguous sequence segmentation:
quadratic work inside a chunk, only the (C, n, m) state crossing chunk
boundaries.  The sLSTM is strictly sequential (its recurrence goes
through h_{t-1}) and runs as a Python loop over the positions.

Stabilization follows the paper: a running max-state m keeps the
exponential gates bounded; all gate math in float32 log space.  States
start with m = -inf, and every product with a factor exp(-inf) = 0
meets finite values, so no inf - inf arises.

The 125M config has d_ff=0: blocks carry their own projections, there is
no separate FFN.  States are tuples, (C, n, m) per mLSTM layer and
(c, n, m, h) per sLSTM layer; blocks return new ones.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..sharding import (ShardCtx, from_local, is_dtensor, matmul_rows,
                        merge_dims, unflatten_dim)
from .common import PSpec, cross_entropy, place_state, remat, rms_norm
from .config import ModelConfig
from .transformer import embed, unembed

MIN_DENOM = 1.0
GATES = ("z", "i", "f", "o")


def _log_sigmoid(x):
    """``F.logsigmoid``; on a DTensor on its local block (DTensor has no
    rule for ``log_sigmoid_backward``), a partial sum reduced first."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import Replicate
    places = tuple(Replicate() if p.is_partial() else p
                   for p in x.placements)
    if places != tuple(x.placements):
        x = x.redistribute(x.device_mesh, places)
    return from_local(F.logsigmoid(x.to_local()), x.device_mesh, places,
                      x.shape)


def _proj(x, w, split: ShardCtx | None = None, heads: bool = True):
    """einsum("bld,dhp->blhp", x, w) as one product (batched over the
    rows on a mesh: :func:`~repro_torch.sharding.matmul_rows`); without
    ``heads``, its (b, l, h*p) view.  ``split`` (the fallback of
    :func:`_split_cols`) puts the product's columns on "model"."""
    wm = merge_dims(w, 1)
    if split is not None:
        wm = split.constrain(wm, None, "tp")
    y = matmul_rows(x, wm)
    return unflatten_dim(y, -1, w.shape[1:]) if heads else y


def _split_cols(ctx: ShardCtx, bax, hax) -> ShardCtx | None:
    """``ctx`` where a block's scan falls back to its rows over ``dp``
    and its heads whole (too few heads for "model", too few rows for the
    mesh: ``ShardCtx.scan_axes``), else ``None``.  There the scan runs
    whole on every "model" rank, and the block's products split over
    "model" by their columns (heads x head dim, gathered for the scan)
    and by their contraction (the output product, summed)."""
    return ctx if (bax, hax) == ("dp", None) else None


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_pdim(cfg: ModelConfig) -> int:
    """mLSTM head dim after the block's x2 up-projection (the paper's
    proj_factor=2)."""
    return 2 * cfg.d_head


def mlstm_param_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    d, h = cfg.d_model, cfg.n_heads
    p = mlstm_pdim(cfg)
    f32 = torch.float32
    return {
        "ln": PSpec((d,), (None,), init="ones"),
        "wq": PSpec((d, h, p), ("fsdp", "tp", None)),
        "wk": PSpec((d, h, p), ("fsdp", "tp", None)),
        "wv": PSpec((d, h, p), ("fsdp", "tp", None)),
        "wi": PSpec((d, h), ("fsdp", "tp"), dtype=f32),
        "wf": PSpec((d, h), ("fsdp", "tp"), dtype=f32),
        "bi": PSpec((h,), ("tp",), dtype=f32, init="zeros"),
        "bf": PSpec((h,), ("tp",), dtype=f32, init="ones"),
        "wog": PSpec((d, h, p), ("fsdp", "tp", None)),
        "out": PSpec((h, p, d), ("tp", None, "fsdp")),
    }


def _mlstm_zero_state(b, h, p, device):
    return (torch.zeros((b, h, p, p), dtype=torch.float32, device=device),
            torch.zeros((b, h, p), dtype=torch.float32, device=device),
            torch.full((b, h), -torch.inf, dtype=torch.float32,
                       device=device))


def mlstm_sequential(q, k, v, log_i, log_f, state=None):
    """Oracle / decode path.  q,k,v: (b, l, h, p); log_i/f: (b, l, h).
    state = (C: (b,h,p,p), n: (b,h,p), m: (b,h)).  Returns (y, state)."""
    b, l, h, p = q.shape
    C, n, m = state if state is not None else _mlstm_zero_state(
        b, h, p, q.device)
    ys = []
    # per-step views from one unbind each: their grads stack once (a
    # select per step would add a zero tensor of the whole sequence per
    # step, quadratic in it)
    for qt, kt, vt, li, lf in zip(*(a.unbind(1) for a in
                                    (q, k, v, log_i, log_f))):
        qt, kt, vt = qt.float(), kt.float(), vt.float()
        m_new = torch.maximum(lf + m, li)
        fprime = torch.exp(lf + m - m_new)
        iprime = torch.exp(li - m_new)
        C = (fprime[..., None, None] * C
             + iprime[..., None, None] * (kt[..., :, None] * vt[..., None, :]))
        n = fprime[..., None] * n + iprime[..., None] * kt
        num = (qt[..., None, :] @ C)[..., 0, :]                  # (b,h,p)
        den = torch.abs(torch.sum(qt * n, dim=-1))
        # stabilized floor: max(|q.n~|, exp(-m)) in the scaled frame
        # == max(|q.n|, 1) in the true frame (paper eq. 19)
        ys.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(ys, dim=1), (C, n, m)


def mlstm_chunked(q, k, v, log_i, log_f, chunk: int, state=None):
    """Chunkwise-parallel mLSTM, matching :func:`mlstm_sequential`.

    Intra-chunk: attention-like with decay matrix D_ij = exp(F_i - F_j +
    I_j); inter-chunk: the (C, n) state with a per-chunk stabilizer
    handoff.  A ragged last chunk is padded with log_i = -1e30."""
    b, l, h, p = q.shape
    pad = -l % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    nc = q.shape[1] // chunk

    def heads_first(a):                # (b, l, h, p) -> (b, c, h, q, p)
        return a.reshape(b, nc, chunk, h, p).float().permute(0, 1, 3, 2, 4)

    qc, kc, vc = heads_first(q), heads_first(k), heads_first(v)
    lic = log_i.reshape(b, nc, chunk, h).transpose(-1, -2)      # (b,c,h,q)
    lfc = log_f.reshape(b, nc, chunk, h).transpose(-1, -2)

    Fc = torch.cumsum(lfc, dim=-1)                # F_i = sum_{k<=i} lf_k
    Ftot = Fc[..., -1]                            # (b,c,h)
    C, n, m = state if state is not None else _mlstm_zero_state(
        b, h, p, q.device)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    # log decay j -> i within chunk (+ input gate of j)
    logD = Fc[..., :, None] - Fc[..., None, :] + lic[..., None, :]
    logD = torch.where(tri, logD, -torch.inf)     # (b,c,h,i,j)

    ys = []
    # per-chunk views from one unbind each (see mlstm_sequential)
    for qh, kh, vh, li, Fb, Ft, logD_b in zip(*(
            a.unbind(1) for a in (qc, kc, vc, lic, Fc, Ftot, logD))):
        # stabilizer per position: max over inter (Fb + m) and intra terms
        m_pos = torch.maximum(Fb + m[..., None], torch.amax(logD_b, dim=-1))
        w = torch.exp(logD_b - m_pos[..., None])                # (b,h,i,j)
        s = (qh @ kh.transpose(-1, -2)) * w
        inter_scale = torch.exp(Fb + m[..., None] - m_pos)      # (b,h,i)
        num = s @ vh + inter_scale[..., None] * (qh @ C)
        # denominator: q_i . n_i = sum_j w_ij (q_i.k_j) + inter q.n_prev
        den_q = torch.abs(torch.sum(s, dim=-1)
                          + inter_scale * (qh @ n[..., None])[..., 0])
        ys.append(num / torch.maximum(den_q, torch.exp(-m_pos))[..., None])
        # state update to the end of the chunk
        tail = Ft[..., None] - Fb + li                          # (b,h,j)
        m_new = torch.maximum(Ft + m, torch.amax(tail, dim=-1))
        decay_j = torch.exp(tail - m_new[..., None])
        carry = torch.exp(Ft + m - m_new)
        kd = kh * decay_j[..., None]
        C = carry[..., None, None] * C + kd.transpose(-1, -2) @ vh
        n = carry[..., None] * n + torch.sum(kd, dim=-2)
        m = m_new
    y = torch.stack(ys, dim=1)                                  # (b,c,h,q,p)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, h, p)[:, :l]
    return y, (C, n, m)


def _state_axes(shapes, axes) -> list:
    """(shape, logical axes) of each state leaf (b, h, ...): ``axes``
    for its batch and heads (``ShardCtx.scan_axes``)."""
    return [(s, tuple(axes) + (None,) * (len(s) - 2)) for s in shapes]


def mlstm_block(pp: dict, x, cfg: ModelConfig, ctx: ShardCtx, state=None):
    b, l, d = x.shape
    h, p = cfg.n_heads, mlstm_pdim(cfg)
    # the sequence whole for the products and the chunked scan (the
    # residual keeps its split; Megatron's sequence parallelism)
    xn = ctx.constrain(layer_norm_like(x, pp["ln"], cfg), "dp", None, None)
    bax, hax = ctx.scan_axes(b, h)
    split = _split_cols(ctx, bax, hax)
    q = _proj(xn, pp["wq"], split)
    # K over sqrt(p) taken in x's dtype (bfloat16 makes sqrt(384)
    # 19.625), as a host number: no device tensor, no copy per call
    k = _proj(xn, pp["wk"], split) / float(
        torch.sqrt(torch.tensor(float(p), dtype=x.dtype)))
    v = _proj(xn, pp["wv"], split)
    xf = xn.float()
    log_i = matmul_rows(xf, pp["wi"]) + pp["bi"]
    log_f = _log_sigmoid(matmul_rows(xf, pp["wf"]) + pp["bf"])
    chunk = cfg.ssm.chunk if cfg.ssm else 64

    def scan(q, k, v, log_i, log_f, *st):
        if l == 1 and st:
            y, st = mlstm_sequential(q, k, v, log_i, log_f, st)
        else:
            y, st = mlstm_chunked(q, k, v, log_i, log_f, chunk=chunk,
                                  state=st or None)
        return (y,) + tuple(st)
    # on a mesh, on each rank's (batch, heads) blocks: the scan's
    # reshapes, its cumsum (whose backward is aten.flip) and its small
    # per-chunk ops have no DTensor form on torch 2.11 or take one plan
    # each
    heads = (bax, None, hax, None)
    st_axes = _state_axes(((b, h, p, p), (b, h, p), (b, h)), (bax, hax))
    y, *new_state = ctx.blocks(
        scan, [heads] * 3 + [heads[:3]] * 2
        + [ax for _, ax in st_axes[:len(state or ())]],
        [(q.shape, heads)] + st_axes, q, k, v, log_i, log_f,
        *(state or ()))
    new_state = tuple(new_state)
    og = torch.sigmoid(_proj(xf, pp["wog"].float(), split, heads=False))
    yh = merge_dims(y) * og
    return x + _out(yh.to(x.dtype), pp["out"], ctx, split), new_state


def _out(y, w, ctx: ShardCtx, split: ShardCtx | None):
    """The block's output product, y (b, l, h*p) against ``w`` (h, p,
    d), on the residual's axes; ``split``: its contraction on "model"
    (:func:`_split_cols`)."""
    wm = merge_dims(w, 0)
    if split is not None:
        wm = split.constrain(wm, "tp", None)
    return ctx.constrain(matmul_rows(y, wm), "dp", None, None)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_param_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    d, h, p = cfg.d_model, cfg.n_heads, cfg.d_head
    f32 = torch.float32
    specs = {"ln": PSpec((d,), (None,), init="ones"),
             "out": PSpec((h, p, d), ("tp", None, "fsdp"))}
    for g in GATES:
        specs[f"w{g}"] = PSpec((d, h, p), ("fsdp", "tp", None), dtype=f32)
        specs[f"r{g}"] = PSpec((h, p, p), ("tp", None, None), dtype=f32,
                               init_scale=0.5)
        specs[f"b{g}"] = PSpec((h, p), ("tp", None), dtype=f32,
                               init="zeros")
    return specs


def _slstm_zero_state(b, h, p, device):
    zeros = torch.zeros((b, h, p), dtype=torch.float32, device=device)
    return (zeros, zeros,
            torch.full((b, h, p), -torch.inf, dtype=torch.float32,
                       device=device), zeros)


def slstm_scan(pp: dict, xn, state=None, ctx: ShardCtx | None = None):
    """xn: (b, l, d) normalized input.  Sequential (recurrence through h).
    The four gates' input and recurrent products each run as one product
    over the gates side by side; every gate column is summed on its own,
    as in four products."""
    ctx = ctx or ShardCtx()
    b, l, d = xn.shape
    h, p = pp["wz"].shape[1], pp["wz"].shape[2]
    w_all = torch.cat([pp[f"w{g}"] for g in GATES], dim=-1)      # (d,h,4p)
    b_all = torch.cat([pp[f"b{g}"] for g in GATES], dim=-1)      # (h,4p)
    r_all = torch.cat([pp[f"r{g}"] for g in GATES], dim=-1)      # (h,p,4p)
    bax, hax = ctx.scan_axes(b, h)
    pre = _proj(xn.float(), w_all, _split_cols(ctx, bax, hax)) + b_all
    # on a mesh, on each rank's (rows, heads) blocks: every step is
    # local to a (row, head), and DTensor would plan its ops anew per
    # token
    st_axes = _state_axes(((b, h, p),) * 4, (bax, hax))
    y, *new_state = ctx.blocks(
        _slstm_steps, [(bax, None, hax, None), (hax, None, None)]
        + [ax for _, ax in st_axes[:len(state or ())]],
        [(pre.shape[:3] + (p,), (bax, None, hax, None))] + st_axes,
        pre, r_all, *(state or ()))
    return y, tuple(new_state)


class _Recurrent(torch.autograd.Function):
    """``(h[:, :, None, :] @ r)[:, :, 0]``, h (b, heads, p) against r
    (heads, p, 4p), with the products and sums of autograd's own
    forward and backward, but saving h and r: the broadcast product
    copies r once per row, and autograd would keep that copy for every
    step of the sequence (b x r's bytes a token: 155 GB a sLSTM layer of
    xlstm-125m's ``train_4k``, 16 rows a device)."""

    @staticmethod
    def forward(ctx, h, r):
        ctx.save_for_backward(h, r)
        return (h[:, :, None, :] @ r)[:, :, 0]

    @staticmethod
    def backward(ctx, grad):
        h, r = ctx.saved_tensors
        b, heads, p = h.shape
        q = r.shape[-1]
        a = h.reshape(b * heads, 1, p)
        w = r.expand(b, heads, p, q).reshape(b * heads, p, q)
        g = grad.reshape(b * heads, 1, q)
        grad_h = g.bmm(w.transpose(1, 2)).view(b, heads, p)
        grad_r = a.transpose(1, 2).bmm(g).view(b, heads, p, q).sum(0)
        return grad_h, grad_r


def _slstm_steps(pre, r_all, *state):
    """The sLSTM recurrence over ``pre`` (b, l, h, 4p), the gates' input
    products, from ``state`` (c, n, m, h) or zeros; returns (y, c, n, m,
    h)."""
    b, _, h, p4 = pre.shape
    p = p4 // 4
    c, n, m, hprev = state or _slstm_zero_state(b, h, p, pre.device)
    ys = []
    # per-step views from one unbind (see mlstm_sequential)
    for pre_t in pre.unbind(1):
        g = pre_t + _Recurrent.apply(hprev, r_all)               # (b,h,4p)
        zt = torch.tanh(g[..., :p])
        li = g[..., p:2 * p]
        lf = _log_sigmoid(g[..., 2 * p:3 * p])
        ot = torch.sigmoid(g[..., 3 * p:])
        m_new = torch.maximum(lf + m, li)
        ip = torch.exp(li - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        hprev = ot * c / torch.clamp(n, min=MIN_DENOM)
        m = m_new
        ys.append(hprev)
    return torch.stack(ys, dim=1), c, n, m, hprev


def slstm_block(pp: dict, x, cfg: ModelConfig, ctx: ShardCtx, state=None):
    b, l, d = x.shape
    xn = ctx.constrain(layer_norm_like(x, pp["ln"], cfg), "dp", None, None)
    y, new_state = slstm_scan(pp, xn, state, ctx)
    split = _split_cols(ctx, *ctx.scan_axes(b, cfg.n_heads))
    return x + _out(merge_dims(y.to(x.dtype)), pp["out"], ctx,
                    split), new_state


def layer_norm_like(x, scale, cfg: ModelConfig):
    return rms_norm(x, scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def _layer_keys(cfg: ModelConfig):
    """(key, is_slstm) per layer, in layer order."""
    return [((f"s_{li}", True) if li in cfg.slstm_layers
             else (f"m_{li}", False)) for li in range(cfg.n_layers)]


def xlstm_param_specs(cfg: ModelConfig) -> dict[str, Any]:
    layers = {key: (slstm_param_specs(cfg) if s else mlstm_param_specs(cfg))
              for key, s in _layer_keys(cfg)}
    return {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("tp", "fsdp"),
                       init="embed"),
        "ln_final": PSpec((cfg.d_model,), (None,), init="ones"),
        "layers": layers,
    }


def xlstm_apply(params, h, cfg: ModelConfig, ctx: ShardCtx, states=None):
    """Returns (h, new states) (``None`` without ``states``)."""
    new_states = {} if states is not None else None
    for key, s in _layer_keys(cfg):
        block = slstm_block if s else mlstm_block
        st = states[key] if states is not None else None
        h, ns = remat(cfg.remat, block,
                      ctx.gather_weights(params["layers"][key]), h, cfg,
                      ctx, st)
        if states is not None:
            new_states[key] = ns
    h = rms_norm(h, ctx.gather_weights(params["ln_final"]), cfg.norm_eps)
    return h, new_states


def xlstm_loss(params, batch, cfg: ModelConfig, ctx: ShardCtx):
    """The training loss; autograd differentiates it."""
    h = embed(params, batch["tokens"], cfg, ctx)
    h, _ = xlstm_apply(params, h, cfg, ctx)
    logits = unembed(params, h[:, :-1], cfg, ctx)
    loss = cross_entropy(logits, batch["tokens"][:, 1:])
    return loss, {"loss": loss}


def xlstm_state_init(cfg: ModelConfig, batch: int, device=None):
    """Zeroed states with m = -inf, on ``device`` (``None``: the card;
    raises where CUDA is missing)."""
    dev = resolve_device(device)
    b, h = batch, cfg.n_heads
    return {key: (_slstm_zero_state(b, h, cfg.d_head, dev) if s
                  else _mlstm_zero_state(b, h, mlstm_pdim(cfg), dev))
            for key, s in _layer_keys(cfg)}


def xlstm_state_specs(cfg: ModelConfig, batch: int):
    """The reference's specs: every leaf ``init="zeros"``, m included,
    while :func:`xlstm_state_init` starts m at -inf."""
    b, h = batch, cfg.n_heads
    ps, pm = cfg.d_head, mlstm_pdim(cfg)
    bax = "dp" if batch > 1 else None
    f32 = torch.float32
    states = {}
    for key, s in _layer_keys(cfg):
        if s:
            v = PSpec((b, h, ps), (bax, "tp", None), dtype=f32, init="zeros")
            states[key] = (v, v, v, v)
        else:
            states[key] = (
                PSpec((b, h, pm, pm), (bax, "tp", None, None), dtype=f32,
                      init="zeros"),
                PSpec((b, h, pm), (bax, "tp", None), dtype=f32,
                      init="zeros"),
                PSpec((b, h), (bax, "tp"), dtype=f32, init="zeros"),
            )
    return states


def xlstm_prefill(params, batch, cfg: ModelConfig, ctx: ShardCtx,
                  max_len: int | None = None):
    tokens = batch["tokens"]
    b, s = tokens.shape
    states = place_state(xlstm_state_init(cfg, b,
                                          device=params["embed"].device),
                         xlstm_state_specs(cfg, b), ctx)
    h = embed(params, tokens, cfg, ctx)
    h, states = xlstm_apply(params, h, cfg, ctx, states)
    logits = unembed(params, h[:, -1:], cfg, ctx)
    return states, s, logits


def xlstm_decode(params, states, cache_len: int, tokens, cfg: ModelConfig,
                 ctx: ShardCtx):
    h = embed(params, tokens, cfg, ctx)
    h, states = xlstm_apply(params, h, cfg, ctx, states)
    logits = unembed(params, h, cfg, ctx)
    return states, cache_len + tokens.shape[1], logits
