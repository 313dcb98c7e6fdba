"""Shared model substrate: param specs, init, norms, rope, losses.

Parameters are plain nested dicts of tensors.  Their shapes are declared
once as :class:`PSpec` trees, with the logical sharding axes of the
reference kept as data (:mod:`repro_torch.sharding`).  A tree is walked
in sorted key order, the order ``jax.tree`` uses, so one generator seed
gives one set of parameters whatever order the dicts were built in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch
import torch.utils.checkpoint

from ..device import resolve_device

PyTree = Any
DEFAULT_PARAM_DTYPE = torch.bfloat16
# init draws a stacked tensor in float32 slices of at most this many
# elements, then casts each slice: qwen3-14b's stacked w_in is 7.1e9
# elements, a 28.5 GB float32 temporary if drawn whole
INIT_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]         # logical sharding per dim
    dtype: torch.dtype = DEFAULT_PARAM_DTYPE
    init: str = "normal"                    # normal|zeros|ones|embed
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def tree_map(fn: Callable, tree: PyTree, is_leaf=is_pspec) -> PyTree:
    """``fn`` on every leaf of nested dicts and tuples (leaves:
    ``is_leaf`` or anything that is neither; xLSTM's states are
    tuples)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def tree_leaves(tree: PyTree, is_leaf=is_pspec) -> Iterator:
    """The leaves of nested dicts and tuples, dicts in sorted key order,
    tuples in theirs (``jax.tree.leaves``' order)."""
    if is_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], is_leaf)
    elif isinstance(tree, tuple):
        for t in tree:
            yield from tree_leaves(t, is_leaf)
    else:
        yield tree


def _init_one(gen: torch.Generator, spec: PSpec,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init not in ("normal", "embed"):
        raise ValueError(f"unknown init {spec.init}")
    # the reference's fan-in: the stacked shape's second-to-last dim
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.init_scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    if out.ndim == 0:
        return out.copy_(torch.randn((), generator=gen, device=device) * std)
    rows = max(1, INIT_CHUNK // max(1, math.prod(spec.shape[1:])))
    for r in range(0, spec.shape[0], rows):
        part = out[r:r + rows]
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32) * std)
    return out


def init_params(gen: torch.Generator, specs: PyTree,
                device=None) -> PyTree:
    """Random parameters for ``specs`` from ``gen``, on ``device``
    (``None``: the card).  ``gen`` must live on that device."""
    dev = resolve_device(device)
    return tree_map(lambda s: _init_one(gen, s, dev), specs)


def param_count(specs: PyTree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def stack_specs(spec_tree: PyTree, n: int) -> PyTree:
    """Add a leading layer-stack dim (the reference scans over it; the
    port loops over its units)."""
    return tree_map(
        lambda s: PSpec((n,) + s.shape, (None,) + s.logical, s.dtype,
                        s.init, s.init_scale), spec_tree)


def remat(enabled: bool, fn: Callable, *args):
    """``fn(*args)``; with ``enabled`` and grad on, its activations are
    recomputed in the backward pass instead of kept (the reference's
    ``jax.checkpoint``).  The recompute runs the same ops in the same
    order, so losses and grads are bit-identical either way."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.float()
    if plus_one:                      # gemma-style (1 + scale)
        s = 1.0 + s
    return (y * s).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)      # a Python base: no host copy
    angles = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE.  logits (..., V) f32; labels (...) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
