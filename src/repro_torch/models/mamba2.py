"""Mamba2 (SSD) block: chunked parallel scan + single-step decode.

The SSD chunked algorithm is a block-contiguous segmentation of the
sequence: intra-chunk work is local (quadratic in the small chunk), and
only a compact state crosses chunk boundaries, the stencil-segment halo
structure.  The depthwise causal conv (k=4) is a 1-D stencil over the
sequence; like the reference, the port runs it as four shifted
multiply-adds in float32, not through the stencil kernels.

Math follows the SSD formulation (Mamba-2, arXiv:2405.21060), n_groups=1:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ,  y_t = C_t . h_t + D x_t
All decay math in float32 log space.  The reference's three- and
four-operand einsums are written as pairwise products in a fixed order,
so no contraction order is left to ``opt_einsum`` and no
(b, c, i, j, h, p) product is ever formed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..sharding import ShardCtx, matmul_rows
from .common import PSpec, rms_norm
from .config import ModelConfig


def mamba_param_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    s = cfg.ssm
    d, di = cfg.d_model, s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    conv_dim = di + 2 * gn
    return {
        "wz": PSpec((d, di), ("fsdp", "tp")),
        "wx": PSpec((d, di), ("fsdp", "tp")),
        "wB": PSpec((d, gn), ("fsdp", None)),
        "wC": PSpec((d, gn), ("fsdp", None)),
        "wdt": PSpec((d, h), ("fsdp", "tp")),
        "conv_w": PSpec((s.d_conv, conv_dim), (None, "tp")),
        "conv_b": PSpec((conv_dim,), ("tp",), init="zeros"),
        "A_log": PSpec((h,), ("tp",), dtype=torch.float32, init="zeros"),
        "dt_bias": PSpec((h,), ("tp",), dtype=torch.float32, init="zeros"),
        "Dskip": PSpec((h,), ("tp",), dtype=torch.float32, init="ones"),
        "norm": PSpec((di,), ("tp",), init="ones"),
        "out": PSpec((di, d), ("tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv (a 1-D stencil).  x: (B, L, C); w: (K, C).
    Taps summed in float32 from zero in tap order, then the bias, SiLU
    and the cast.  With ``state`` (B, K-1, C) prepended (decode); returns
    (y, new_state)."""
    k = w.shape[0]
    if state is not None:
        xc = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xc = F.pad(x, (0, 0, k - 1, 0))
    new_state = xc[:, -(k - 1):]
    l = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xc[:, i:i + l].float() * w[i].float()
    y = y + b.float()
    return F.silu(y).to(x.dtype), new_state


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < k <= i} la[k] (log decay j -> i), -inf for j > i."""
    q = la.shape[-1]
    cs = torch.cumsum(la, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]     # CA_i - CA_j
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=la.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward.  x: (b, l, h, p); dt: (b, l, h); A: (h,);
    B, C: (b, l, n).  Returns y: (b, l, h, p) float32 and the final state
    (b, h, p, n), from a zero state."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    pad = -l % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    lc = x.shape[1]
    nc = lc // chunk
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    la = (dtc * A).transpose(-1, -2)                      # (b,c,h,q), <= 0
    Lmat = torch.exp(_segsum(la))                         # (b,c,h,q,q)
    # dt_j x_j, heads first: (b,c,h,q,p)
    xw = (x.reshape(b, nc, chunk, h, p).float()
          * dtc[..., None]).permute(0, 1, 3, 2, 4)

    # intra-chunk output: ((C_i . B_j) L_ij) @ xw
    cb = Cc @ Bc.transpose(-1, -2)                        # (b,c,i,j)
    y_diag = (cb[:, :, None] * Lmat) @ xw                 # (b,c,h,i,p)

    # end-of-chunk states: decay from j to chunk end
    cums = torch.cumsum(la, dim=-1)                       # (b,c,h,q)
    decay_to_end = torch.exp(cums[..., -1:] - cums)       # (b,c,h,q)
    S = (xw * decay_to_end[..., None]).transpose(-1, -2) @ Bc[:, :, None]

    # inter-chunk recurrence over c
    chunk_decay = torch.exp(torch.sum(la, dim=-1))        # (b,c,h)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    # per-chunk views from one unbind each: their grads stack once (a
    # select per chunk would add a zero tensor of every chunk per chunk)
    for decay_c, S_c in zip(chunk_decay.unbind(1), S.unbind(1)):
        s_prevs.append(s)
        s = decay_c[:, :, None, None] * s + S_c
    s_prev = torch.stack(s_prevs, dim=1)                  # (b,c,h,p,n)

    # contribution of earlier chunks: C_i . (decay_from_start_i * S_prev)
    decay_from_start = torch.exp(cums)                    # (b,c,h,q)
    y_off = ((Cc[:, :, None] @ s_prev.transpose(-1, -2))
             * decay_from_start[..., None])               # (b,c,h,i,p)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, lc, h, p)
    return y[:, :l], s


def ssd_step(state, x, dt, A, B, C):
    """One decode step.  state: (b,h,p,n); x: (b,h,p); dt: (b,h);
    B, C: (b, n)."""
    dtf = dt.float()
    da = torch.exp(dtf * A)                               # (b,h)
    upd = ((dtf[..., None] * x.float())[..., None]
           * B.float()[:, None, None, :])                 # (b,h,p,n)
    new_state = da[..., None, None] * state + upd
    y = (new_state @ C.float()[:, None, :, None])[..., 0]  # (b,h,p)
    return new_state, y


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx,
                state: dict | None = None):
    """x: (B, L, D) -> (y, new_state).  state: {conv: (B,K-1,Cc), ssm:
    (B,H,P,N)}.  With more than one position the chunked path runs from
    a zero SSM state, whatever ``state`` holds, as the reference's does."""
    s = cfg.ssm
    b, l, d = x.shape
    di = s.d_inner(d)
    h = s.n_heads(d)
    n = s.n_groups * s.d_state
    # batched over the rows (sharding.matmul_rows): a product's backward
    # views its grad as rows, which torch 2.11 refuses for a grad whose
    # sequence dim DTensor split over "model"; each placed as its weight's
    # columns are (torch 2.11 cannot add a split bias to a partial sum)
    z = ctx.constrain(matmul_rows(x, p["wz"]), "dp", None, "tp")
    xin = ctx.constrain(matmul_rows(x, p["wx"]), "dp", None, "tp")
    Bp = ctx.constrain(matmul_rows(x, p["wB"]), "dp", None, None)
    Cp = ctx.constrain(matmul_rows(x, p["wC"]), "dp", None, None)
    dt = ctx.constrain(matmul_rows(x, p["wdt"]), "dp", None, "tp")

    conv_in = torch.cat([xin, Bp.to(xin.dtype), Cp.to(xin.dtype)], dim=-1)
    # depthwise, on each rank's rows with the channels whole (torch 2.11's
    # DTensor fails to plan the pad's redistribution in training, and
    # to cut x, B and C out of channels split over "model")
    chans = ("dp", None, None)
    st = () if state is None else (state["conv"],)
    conv_out, conv_state = ctx.blocks(
        _causal_conv,
        [chans, (None, None), (None,)] + [chans] * len(st),
        [(conv_in.shape, chans),
         ((b, s.d_conv - 1, conv_in.shape[-1]), chans)],
        conv_in, p["conv_w"], p["conv_b"], *st)
    conv_state = ctx.constrain(conv_state, "dp", None, "tp")  # the state's
    xin = conv_out[..., :di]
    Bp = conv_out[..., di:di + n]
    Cp = conv_out[..., di + n:]

    A = -torch.exp(p["A_log"].float())
    dtf = F.softplus(dt.float() + p["dt_bias"])
    xh = xin.reshape(b, l, h, s.head_dim)
    xh = ctx.constrain(xh, "dp", None, "tp", None)

    # the scan on each rank's (batch, heads) blocks: its reshapes and
    # products over batch, chunk and heads have no DTensor view on torch
    # 2.11; B and C are whole on every head's rank
    heads = ("dp", None, "tp", None)
    bc = ("dp", None, None)
    st_ax = ((b, h, s.head_dim, n), ("dp", "tp", None, None))
    if state is None or l > 1:
        y, final_state = ctx.blocks(
            lambda *a: ssd_chunked(*a, s.chunk),
            [heads, heads[:3], ("tp",), bc, bc],
            [(xh.shape, heads), st_ax], xh, dtf, A, Bp, Cp)
        new_state = {"conv": conv_state, "ssm": final_state}
    else:
        new_ssm, y1 = ctx.blocks(
            ssd_step, [st_ax[1], heads[:1] + heads[2:], ("dp", "tp"),
                       ("tp",), bc[:1] + bc[2:], bc[:1] + bc[2:]],
            [st_ax, ((b, h, s.head_dim), ("dp", "tp", None))],
            state["ssm"], xh[:, 0], dtf[:, 0], A, Bp[:, 0], Cp[:, 0])
        y = y1[:, None]
        new_state = {"conv": conv_state, "ssm": new_ssm}

    y = y + p["Dskip"][:, None] * xh.float()
    y = y.reshape(b, l, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["out"]
    return ctx.constrain(out, "dp", None, None), new_state


def _state_shapes(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return ((batch, s.d_conv - 1, conv_dim),
            (batch, s.n_heads(cfg.d_model), s.head_dim, s.d_state))


def mamba_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zeroed conv (bfloat16) and SSM (float32) state on ``device``
    (``None``: the card; raises where CUDA is missing)."""
    dev = resolve_device(device)
    conv, ssm = _state_shapes(cfg, batch)
    return {"conv": torch.zeros(conv, dtype=torch.bfloat16, device=dev),
            "ssm": torch.zeros(ssm, dtype=torch.float32, device=dev)}


def mamba_state_specs(cfg: ModelConfig, batch: int) -> dict:
    conv, ssm = _state_shapes(cfg, batch)
    batch_ax = "dp" if batch > 1 else None
    return {
        "conv": PSpec(conv, (batch_ax, None, "tp"), dtype=torch.bfloat16,
                      init="zeros"),
        "ssm": PSpec(ssm, (batch_ax, "tp", None, None), dtype=torch.float32,
                     init="zeros"),
    }
