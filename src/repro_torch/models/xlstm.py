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
from ..sharding import ShardCtx
from .common import PSpec, cross_entropy, place_state, remat, rms_norm
from .config import ModelConfig
from .transformer import embed, unembed

MIN_DENOM = 1.0
GATES = ("z", "i", "f", "o")


def _proj(x, w):
    """einsum("bld,dhp->blhp", x, w) as one product."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


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
    for t in range(l):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        li, lf = log_i[:, t], log_f[:, t]
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
    for ci in range(nc):
        qh, kh, vh = qc[:, ci], kc[:, ci], vc[:, ci]            # (b,h,q,p)
        li, Fb, Ft, logD_b = lic[:, ci], Fc[:, ci], Ftot[:, ci], logD[:, ci]
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


def mlstm_block(pp: dict, x, cfg: ModelConfig, ctx: ShardCtx, state=None):
    b, l, d = x.shape
    h, p = cfg.n_heads, mlstm_pdim(cfg)
    xn = layer_norm_like(x, pp["ln"], cfg)
    q = _proj(xn, pp["wq"])
    # K over sqrt(p) taken in x's dtype (bfloat16 makes sqrt(384)
    # 19.625), as a host number: no device tensor, no copy per call
    k = _proj(xn, pp["wk"]) / float(
        torch.sqrt(torch.tensor(float(p), dtype=x.dtype)))
    v = _proj(xn, pp["wv"])
    xf = xn.float()
    log_i = xf @ pp["wi"] + pp["bi"]
    log_f = F.logsigmoid(xf @ pp["wf"] + pp["bf"])
    if l == 1 and state is not None:
        y, new_state = mlstm_sequential(q, k, v, log_i, log_f, state)
    else:
        y, new_state = mlstm_chunked(q, k, v, log_i, log_f,
                                     chunk=cfg.ssm.chunk if cfg.ssm else 64,
                                     state=state)
    og = torch.sigmoid(_proj(xf, pp["wog"].float()))
    yh = y * og
    out = yh.to(x.dtype).reshape(b, l, h * p) @ pp["out"].reshape(h * p, d)
    return x + ctx.constrain(out, "dp", None, None), new_state


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


def slstm_scan(pp: dict, xn, state=None):
    """xn: (b, l, d) normalized input.  Sequential (recurrence through h).
    The four gates' input and recurrent products each run as one product
    over the gates side by side; every gate column is summed on its own,
    as in four products."""
    b, l, d = xn.shape
    h, p = pp["wz"].shape[1], pp["wz"].shape[2]
    w_all = torch.cat([pp[f"w{g}"] for g in GATES], dim=-1)      # (d,h,4p)
    b_all = torch.cat([pp[f"b{g}"] for g in GATES], dim=-1)      # (h,4p)
    r_all = torch.cat([pp[f"r{g}"] for g in GATES], dim=-1)      # (h,p,4p)
    pre = _proj(xn.float(), w_all) + b_all                       # (b,l,h,4p)
    c, n, m, hprev = state if state is not None else _slstm_zero_state(
        b, h, p, xn.device)
    ys = []
    for t in range(l):
        g = pre[:, t] + (hprev[:, :, None, :] @ r_all)[:, :, 0]  # (b,h,4p)
        zt = torch.tanh(g[..., :p])
        li = g[..., p:2 * p]
        lf = F.logsigmoid(g[..., 2 * p:3 * p])
        ot = torch.sigmoid(g[..., 3 * p:])
        m_new = torch.maximum(lf + m, li)
        ip = torch.exp(li - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        hprev = ot * c / torch.clamp(n, min=MIN_DENOM)
        m = m_new
        ys.append(hprev)
    return torch.stack(ys, dim=1), (c, n, m, hprev)


def slstm_block(pp: dict, x, cfg: ModelConfig, ctx: ShardCtx, state=None):
    b, l, d = x.shape
    xn = layer_norm_like(x, pp["ln"], cfg)
    y, new_state = slstm_scan(pp, xn, state)
    w = pp["out"]
    out = y.to(x.dtype).reshape(b, l, -1) @ w.reshape(-1, w.shape[-1])
    return x + ctx.constrain(out, "dp", None, None), new_state


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
        h, ns = remat(cfg.remat, block, params["layers"][key], h, cfg, ctx,
                      st)
        if states is not None:
            new_states[key] = ns
    h = rms_norm(h, params["ln_final"], cfg.norm_eps)
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
