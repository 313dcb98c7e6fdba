"""A CPU mirror of the arithmetic of K5's tensor-core kernel
(``src/repro_torch/kernels/csrc/swa_wgmma.cu``), in plain torch.

It walks the kernel's blocks as the kernel does: per (batch, KV head),
share of the group (``tc_heads_per_cta(G)`` heads; all G up to 16) and
block of ``tc_positions(heads)`` query positions, the heads' rows
head-major; the block's key range ``[max(0, p0 - W + 1), p_hi]`` in
chunks of ``tc_chunk_keys(D)`` keys (keys past S read as zero);
bf16-valued q.k summed in f32, then scaled; softcap as
``softcap * tanh(x * (1/softcap))``, tanh from the kernel's polynomial
(:func:`tanh_small`) where ``|y| <= 0.55`` and ``torch.tanh`` (for
CUDA's ``tanhf``) elsewhere; the position mask only on chunks
that straddle ``k <= p`` or ``k > p - W``; a running max and sum with the
rescale by ``exp2((m_old - m_new) * log2 e)``; p split into ``terms``
bf16 terms and ``sum_t term_t @ v`` in f32; one division and one
rounding to bf16.  A head dim below the kernel's instance (112 on 128,
192 on 256) is walked at its own width: the instance's extra columns are
zeros, which add nothing.  Only the order of the f32 sums differs from
the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.swa import (tc_chunk_keys, tc_heads_per_cta,
                                    tc_positions)

LOG2E = 1.4426950408889634
#: tanh_small's coefficients in csrc/swa_wgmma.cu: Q(t) from t^0 up, in
#: tanh(y) = y + y^3 Q(y^2) for |y| <= 0.55.
TANH_POLY = (-3.333333433e-01, 1.333332360e-01, -5.396465585e-02,
             2.181803063e-02, -8.524764329e-03, 2.524329582e-03)
TANH_SMALL_MAX = 0.55


def _fmaf(a, b, c):
    # f32 fused multiply-add: the exact product, one rounding (via f64)
    return (a.double() * b.double() + c.double()).float()


def tanh_small(y: torch.Tensor) -> torch.Tensor:
    """The kernel's f32 tanh for ``|y| <= 0.55`` (Horner in y^2, fmaf)."""
    y2 = y * y
    q = torch.full_like(y, TANH_POLY[-1])
    for c in TANH_POLY[-2::-1]:
        q = _fmaf(q, y2, torch.full_like(y, c))
    return _fmaf(y * y2, q, y)


def split_bf16(p: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """``p`` (f32) as ``terms`` bf16-valued f32 tensors: each the bf16
    rounding of what the earlier ones left (every residual exact)."""
    out, r = [], p
    for _ in range(terms):
        t = r.to(torch.bfloat16).float()
        out.append(t)
        r = r - t
    return out


def swa_tc_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, softcap: float | None = None,
                  terms: int = 3, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Windowed-causal GQA attention of bf16 q ``(B, Hq, S, D)`` and k/v
    ``(B, Hkv, S, D)`` (CPU tensors) as the tensor-core kernel computes it;
    bf16 out (``out_dtype=torch.float32``: the f32 result before the
    rounding)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    gc = tc_heads_per_cta(g)
    npos, kc = tc_positions(gc), tc_chunk_keys(d)
    w = min(int(window), s)
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=f32)
    inv_cap = None if softcap is None else torch.tensor(1.0 / softcap,
                                                        dtype=f32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(q.shape, dtype=out_dtype)
    blocks = [(bi, h, h * g + g0, min(gc, g - g0), p0)
              for bi in range(b) for h in range(hkv)
              for g0 in range(0, g, gc) for p0 in range(0, s, npos)]
    for bi, h, h0, gl, p0 in blocks:
        p_hi = min(s - 1, p0 + npos - 1)
        n = p_hi - p0 + 1
        k_lo = max(0, p0 - w + 1)
        # rows j*npos + t: head h0 + j, position p0 + t (zero past S)
        qb = torch.zeros(gl, npos, d, dtype=f32)
        qb[:, :n] = qf[bi, h0:h0 + gl, p0:p_hi + 1]
        qb = qb.reshape(gl * npos, d)
        pos = (p0 + torch.arange(npos)).repeat(gl)[:, None]
        m = torch.full((gl * npos,), -math.inf, dtype=f32)
        l = torch.zeros(gl * npos, dtype=f32)
        o = torch.zeros(gl * npos, d, dtype=f32)
        for c0 in range(k_lo, p_hi + 1, kc):
            keys = c0 + torch.arange(kc)
            nk = min(kc, s - c0)
            kb = torch.zeros(kc, d, dtype=f32)
            vb = torch.zeros(kc, d, dtype=f32)
            kb[:nk] = kf[bi, h, c0:c0 + nk]
            vb[:nk] = vf[bi, h, c0:c0 + nk]
            x = (qb @ kb.T) * scale
            if softcap is not None:
                y = x * inv_cap
                x = softcap * torch.where(
                    y.abs() <= TANH_SMALL_MAX, tanh_small(y),
                    torch.tanh(y))
            if not (c0 + kc - 1 <= p0 and c0 > p_hi - w):
                ok = (keys[None] <= pos) & (keys[None] > pos - w)
                x = torch.where(ok, x, -math.inf)
            m_new = torch.maximum(m, x.amax(dim=-1))
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2((m - m_use) * LOG2E)
            p = torch.exp2((x - m_use[:, None]) * LOG2E)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[:, None]
            for t in split_bf16(p, terms):
                o = o + t @ vb
            m = m_new
        res = (o / l[:, None]).to(out_dtype).reshape(gl, npos, d)
        out[bi, h0:h0 + gl, p0:p_hi + 1] = res[:, :n]
    return out
