"""AdamW with f32 master weights and optional 8-bit quantized moments.

The 8-bit state (block-wise scaling, bitsandbytes-style) holds 2 (bf16
param) + 4 (f32 master) + 1 + 1 (int8 m, v) + scales ~= 8.3 B/param
instead of 18 B/param.

All update math is f32, written op by op as the reference writes it (not
``torch.optim.AdamW``, which adds eps to sqrt(v)/sqrt(bc2) and decays
before the step): moments are dequantized, updated and requantized per
step.  The schedule and the bias corrections are f32 tensors, as the
reference computes them.  :func:`apply_updates` updates the params, the
master weights and the moments in place (the reference donates them), so
a step holds one copy of the state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.common import PSpec, is_pspec, tree_leaves, tree_map

QBLOCK = 256         # elements per quantization block
# on the host, a large leaf is updated in slices of about this many
# elements (whole rows), small enough to stay in cache across the update's
# ~18 elementwise passes; every op is elementwise, so the values are the
# same as in one piece.  Its one user is chip_smoke.py's host side of
# phase 2k case (iv): the 1.886e9-parameter f32 update there takes 7.1 s
# in slices against 14-19 s in one piece (8-core host of an H100 machine),
# which keeps the phase inside its 90 s budget; drop this path when that
# host check shrinks.
HOST_SLICE = 1 << 20


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_state: bool = False
    # warmup/cosine schedule
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(c: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), an
    f32 tensor: linear warmup, then cosine down to ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    prog = (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return c.lr * torch.where(step < c.warmup_steps, warm, cos)


# --- 8-bit block quantization ------------------------------------------------
# Blocks run along the LAST axis, so the int8 arrays keep the parameter's
# shape (padded).  m (signed): linear absmax.  v (positive, spans many
# orders of magnitude): linear in log space; absmax-int8 on v rounds small
# entries to zero and the Adam denominator explodes.
def _blocked(x: torch.Tensor) -> torch.Tensor:
    last = x.shape[-1] if x.ndim else 1
    pad = -last % QBLOCK
    if x.ndim == 0:
        x = x.reshape(1)
        pad = QBLOCK - 1
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + (x.shape[-1] // QBLOCK, QBLOCK))


def _unblocked(b: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    flatlast = b.reshape(b.shape[:-2] + (b.shape[-2] * b.shape[-1],))
    if not shape:
        return flatlast.reshape(-1)[0]
    return flatlast[..., :shape[-1]].reshape(shape)


def _quantize_signed(x: torch.Tensor) -> dict:
    b = _blocked(x.float())
    scale = torch.clamp(torch.amax(torch.abs(b), dim=-1, keepdim=True)
                        / 127.0, min=1e-12)
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize_signed(s: dict, shape: tuple[int, ...]) -> torch.Tensor:
    return _unblocked(s["q"].float() * s["scale"], shape)


_LOG_FLOOR = -46.0          # log(1e-20)


def _quantize_log(x: torch.Tensor) -> dict:
    b = _blocked(x.float())
    lv = torch.log(torch.clamp(b, min=1e-20))
    mn = torch.amin(lv, dim=-1, keepdim=True)
    mx = torch.amax(lv, dim=-1, keepdim=True)
    span = torch.clamp(mx - mn, min=1e-6)
    q = torch.clamp(torch.round((lv - mn) / span * 127.0), 0, 127) \
        .to(torch.int8)
    return {"q": q, "mn": mn, "span": span}


def _dequantize_log(s: dict, shape: tuple[int, ...]) -> torch.Tensor:
    lv = s["q"].float() / 127.0 * s["span"] + s["mn"]
    v = torch.where(lv <= _LOG_FLOOR + 1e-3, 0.0, torch.exp(lv))
    return _unblocked(v, shape)


def _is_moment(x) -> bool:
    return torch.is_tensor(x) or (isinstance(x, dict) and "q" in x)


def _store(dst: dict, src: dict) -> None:
    for k in dst:
        dst[k].copy_(src[k])


# --- state -------------------------------------------------------------------
def opt_state_specs(param_specs: Any, c: AdamWConfig) -> dict:
    """PSpec tree of the optimizer state (the params' logical axes)."""
    f32, i8 = torch.float32, torch.int8

    def master(s: PSpec):
        return PSpec(s.shape, s.logical, f32, "zeros")

    def _qshapes(s: PSpec):
        shape = s.shape if s.shape else (1,)
        logical = s.logical if s.shape else (None,)
        nb = -(-shape[-1] // QBLOCK)
        return (shape[:-1] + (nb, QBLOCK), logical[:-1] + (None, None),
                shape[:-1] + (nb, 1))

    def moment(s: PSpec, names):
        if not c.quantize_state:
            return PSpec(s.shape, s.logical, f32, "zeros")
        qshape, qlogical, sshape = _qshapes(s)
        out = {"q": PSpec(qshape, qlogical, i8, "zeros")}
        out |= {n: PSpec(sshape, qlogical, f32, "zeros") for n in names}
        return out

    return {
        "step": PSpec((), (), torch.int32, "zeros"),
        "master": tree_map(master, param_specs, is_pspec),
        "m": tree_map(lambda s: moment(s, ("scale",)), param_specs,
                      is_pspec),
        "v": tree_map(lambda s: moment(s, ("mn", "span")), param_specs,
                      is_pspec),
    }


def init_opt_state(params: Any, c: AdamWConfig) -> dict:
    """Step 0, f32 master copies of ``params`` and zero moments, on the
    params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def moment_m(p):
        return _quantize_signed(zeros(p)) if c.quantize_state else zeros(p)

    def moment_v(p):
        return _quantize_log(zeros(p)) if c.quantize_state else zeros(p)

    dev = next(iter(tree_leaves(params, torch.is_tensor))).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params,
            torch.is_tensor),
        "m": tree_map(moment_m, params, torch.is_tensor),
        "v": tree_map(moment_v, params, torch.is_tensor),
    }


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.detach().to(torch.float32, copy=True).square_())


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves, in the reference's leaf order (dicts
    by sorted key), of each leaf's f32 sum of squares."""
    total = None
    for x in tree_leaves(tree, torch.is_tensor):
        s = _square_sum(x)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, c: AdamWConfig
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step; returns (params, state, metrics).  ``params``
    (cast from the new master weights to each one's dtype) and
    ``state`` are updated in place and returned."""
    state["step"].add_(1)
    step = state["step"]
    gnorm = global_norm(grads)
    clip = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(c, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(c.b1, stepf)
    b2c = 1 - torch.pow(c.b2, stepf)

    def upd(p, g, master, m, v):
        g = g.to(torch.float32) * clip
        if c.quantize_state:
            m_f = _dequantize_signed(m, g.shape)
            v_f = _dequantize_log(v, g.shape)
        else:
            m_f, v_f = m, v
        m_f.mul_(c.b1).add_((1 - c.b1) * g)
        g2 = (1 - c.b2) * g
        v_f.mul_(c.b2).add_(g2.mul_(g))
        del g, g2
        mhat = m_f / b1c
        den = (v_f / b2c).sqrt_().add_(c.eps)
        mhat.div_(den).add_(c.weight_decay * master)
        master.sub_(mhat.mul_(lr))
        del mhat, den
        if c.quantize_state:
            _store(m, _quantize_signed(m_f))
            _store(v, _quantize_log(v_f))
        p.copy_(master)

    for p, g, ma, m, v in zip(
            tree_leaves(params, torch.is_tensor),
            tree_leaves(grads, torch.is_tensor),
            tree_leaves(state["master"], torch.is_tensor),
            tree_leaves(state["m"], _is_moment),
            tree_leaves(state["v"], _is_moment)):
        if (p.device.type == "cpu" and not c.quantize_state
                and p.numel() > HOST_SLICE):
            rows = max(1, HOST_SLICE // p.shape[-1])
            for part in zip(*(t.reshape(-1, t.shape[-1]).split(rows)
                              for t in (p, g, ma, m, v))):
                upd(*part)
        else:
            upd(p, g, ma, m, v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
