"""A CPU mirror of the arithmetic of K5's tensor-core kernels, in plain
torch: ``src/repro_torch/kernels/csrc/swa_wgmma.cu`` (bf16 and f16) and
``csrc/swa_tf32.cu`` (f32 in three TF32 passes).

It walks the kernels' blocks as the kernels do: per (batch, KV head),
share of the group (``tc_heads_per_cta(G)`` heads; all G up to 16) and
block of ``tc_positions(heads)`` query positions, the heads' rows
head-major; the block's key range ``[max(0, p0 - W + 1), p_hi]`` in
chunks of ``tc_chunk_keys(D, dtype)`` keys (keys past S read as zero);
q.k summed in f32 (16-bit q and k multiply exactly; f32 q and k as the
three TF32 products of :func:`split_tf32`), then scaled; softcap as
``softcap * tanh(x * (1/softcap))``, tanh from the kernels' polynomial
(:func:`tanh_small`) where ``|y| <= 0.55`` and ``torch.tanh`` (for
CUDA's ``tanhf``) elsewhere; the position mask only on chunks that
straddle ``k <= p`` or ``k > p - W``; a running max and sum with the
rescale by ``exp2((m_old - m_new) * log2 e)``; P.V with p split into
bf16 terms, into f16 terms of ``p * 2**15``, or, for f32, three TF32
products of p's and v's halves; one division and one rounding to the
output type.  A head dim below the kernel's instance (112 on 128, 192 on
256) is walked at its own width: the instance's extra columns are zeros,
which add nothing.  Only the order of the f32 sums differs from the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.swa import (TC_P_SCALE_F16, TC_TERMS, TC_TERMS_F16,
                                    tc_chunk_keys, tc_heads_per_cta,
                                    tc_positions)

LOG2E = 1.4426950408889634
#: tanh_small's coefficients in csrc/swa_common.cuh: Q(t) from t^0 up, in
#: tanh(y) = y + y^3 Q(y^2) for |y| <= 0.55.
TANH_POLY = (-3.333333433e-01, 1.333332360e-01, -5.396465585e-02,
             2.181803063e-02, -8.524764329e-03, 2.524329582e-03)
TANH_SMALL_MAX = 0.55


def _fmaf(a, b, c):
    # f32 fused multiply-add: the exact product, one rounding (via f64)
    return (a.double() * b.double() + c.double()).float()


def tanh_small(y: torch.Tensor) -> torch.Tensor:
    """The kernels' f32 tanh for ``|y| <= 0.55`` (Horner in y^2, fmaf)."""
    y2 = y * y
    q = torch.full_like(y, TANH_POLY[-1])
    for c in TANH_POLY[-2::-1]:
        q = _fmaf(q, y2, torch.full_like(y, c))
    return _fmaf(y * y2, q, y)


def split_terms(p: torch.Tensor, terms: int,
                dtype: torch.dtype = torch.bfloat16) -> list[torch.Tensor]:
    """``p`` (f32) as ``terms`` ``dtype``-valued f32 tensors: each the
    rounding (nearest even) of what the earlier ones left (every residual
    exact)."""
    out, r = [], p
    for _ in range(terms):
        t = r.to(dtype).float()
        out.append(t)
        r = r - t
    return out


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor as ``mma.sync`` reads it for a ``.tf32`` operand on
    the H100: its low 13 bits dropped (``tools/swa_probe.py``)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (f32) as swa_tf32.cu's two halves, each as the tensor cores
    read it: big = trunc(x), small = trunc(x - trunc(x)) (the difference
    exact in f32)."""
    big = tf32_trunc(x)
    return big, tf32_trunc(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (f32) as swa_tf32.cu forms it: big.big + big.small +
    small.big of the TF32 halves, every product exact, summed in f32."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return as_ @ bb + ab @ bs + ab @ bb


def swa_tc_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, softcap: float | None = None,
                  terms: int | None = None,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Windowed-causal GQA attention of q ``(B, Hq, S, D)`` and k/v
    ``(B, Hkv, S, D)`` (CPU tensors of one dtype) as K5's kernel for that
    dtype computes it; out in q's dtype (``out_dtype=torch.float32``: the
    f32 result before the rounding).  ``terms``: the 16-bit paths' terms
    of P (default: the kernel's count)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    dtype = q.dtype
    gc = tc_heads_per_cta(g)
    npos, kc = tc_positions(gc), tc_chunk_keys(d, dtype)
    if terms is None:
        terms = TC_TERMS_F16 if dtype == torch.float16 else TC_TERMS
    p_scale = TC_P_SCALE_F16 if dtype == torch.float16 else 1.0
    w = min(int(window), s)
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=f32)
    inv_cap = None if softcap is None else torch.tensor(1.0 / softcap,
                                                        dtype=f32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(q.shape, dtype=out_dtype or dtype)
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
            x = (mm_3xtf32(qb, kb.T) if dtype == f32 else qb @ kb.T) * scale
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
            if dtype == f32:
                o = o + mm_3xtf32(p, vb)
            else:
                for t in split_terms(p * p_scale, terms, dtype):
                    o = o + t @ vb
            m = m_new
        res = (o / (l * p_scale)[:, None]).to(out.dtype)
        out[bi, h0:h0 + gl, p0:p_hi + 1] = res.reshape(gl, npos, d)[:, :n]
    return out
