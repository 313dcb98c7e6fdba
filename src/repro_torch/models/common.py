"""Shared model substrate: param specs, init, norms, rope, losses.

Parameters are plain nested dicts of tensors.  Their shapes and
logical sharding axes are declared once as :class:`PSpec` trees; init,
abstract (dry-run) instantiation and sharding all derive from the same
declaration.  A tree is walked in sorted key order, the order
``jax.tree`` uses, so one generator seed gives one set of parameters
whatever order the dicts were built in, on one device or on a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch
import torch.utils.checkpoint

from ..device import resolve_device
from ..sharding import (NamedSharding, as_dtensor, distribute, from_local,
                        is_device_mesh, is_dtensor, placements, resolve)

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


def init_params(gen: torch.Generator, specs: PyTree, device=None, *,
                mesh=None, overrides: dict | None = None) -> PyTree:
    """Random parameters for ``specs`` from ``gen``, on ``device``
    (``None``: the card).  ``gen`` must live on that device.

    With a ``DeviceMesh``, every rank draws each leaf whole on its device,
    one leaf at a time, from the same stream as on one device, and keeps
    only its block as a DTensor (``resolve`` of the leaf's logical axes,
    with ``overrides``): the params equal the single-device ones bit for
    bit, nothing is broadcast, and no rank holds more than one whole
    leaf at a time."""
    dev = resolve_device(device)
    if mesh is None:
        return tree_map(lambda s: _init_one(gen, s, dev), specs)
    return tree_map(lambda s: distribute(
        _init_one(gen, s, dev), mesh, leaf_placements(mesh, s, overrides)),
        specs)


def scale_scores(params: PyTree, specs: PyTree) -> None:
    """Rescale in place every query and key projection (``wq``, ``wk``:
    (d_in, heads, d_head), stacked or not) to std 1/sqrt(d_in).  The
    reference's init takes a weight's second-to-last dim as its fan-in,
    here the head count, so without a qk-norm the scores reach the
    hundreds and one bf16 rounding moves a whole softmax row.
    ``chip_smoke.py`` holds its bf16 serving checks on these weights; on a
    mesh each DTensor leaf scales its own block."""
    for key in sorted(params):
        if isinstance(params[key], dict):
            scale_scores(params[key], specs[key])
        elif key in ("wq", "wk"):
            shape = specs[key].shape
            params[key].mul_(math.sqrt(shape[-2] / shape[-3]))


def leaf_placements(mesh, spec: PSpec, overrides: dict | None = None
                    ) -> tuple:
    """The DTensor placements of a ``spec`` leaf on ``mesh``."""
    return placements(mesh, resolve(mesh, spec.logical, spec.shape,
                                    overrides))


def place_params(params: PyTree, specs: PyTree, mesh,
                 overrides: dict | None = None) -> PyTree:
    """``params`` (whole in every rank: from numpy, or gathered) as
    DTensors on ``mesh``, each rank keeping its block of each leaf."""
    placed = [distribute(t, mesh, leaf_placements(mesh, s, overrides))
              for t, s in zip(tree_leaves(params, torch.is_tensor),
                              tree_leaves(specs))]
    it = iter(placed)
    return tree_map(lambda _: next(it), params, torch.is_tensor)


def place_state(state: PyTree, specs: PyTree, ctx) -> PyTree:
    """A decode state made whole (zeros) placed by its ``specs`` on
    ``ctx``'s compute mesh, as the reference's dry run shards it; the
    identity without a mesh."""
    if not is_device_mesh(ctx.mesh):
        return state
    return place_params(state, specs, ctx.cmesh)


@dataclasses.dataclass(frozen=True)
class AbstractTensor:
    """A leaf's global shape and dtype and, on a mesh, its sharding,
    with no storage (the reference's ``ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding | None = None

    @property
    def shard_shape(self) -> tuple[int, ...]:
        if self.sharding is None:
            return self.shape
        return self.sharding.shard_shape(self.shape)

    @property
    def placements(self) -> tuple | None:
        return None if self.sharding is None else self.sharding.placements

    @property
    def shard_bytes(self) -> int:
        """Bytes of the largest shard (the bytes per device)."""
        return math.prod(self.shard_shape) * self.dtype.itemsize


def abstract_params(specs: PyTree, mesh, overrides: dict | None = None
                    ) -> PyTree:
    """An :class:`AbstractTensor` per leaf, sharded on ``mesh`` (a
    ``DeviceMesh`` or a :class:`~repro_torch.sharding.MeshShape`; the
    dry-run path needs no devices)."""

    def one(s: PSpec):
        if mesh is None:
            return AbstractTensor(s.shape, s.dtype)
        return AbstractTensor(s.shape, s.dtype, NamedSharding(
            mesh, resolve(mesh, s.logical, s.shape, overrides)))

    return tree_map(one, specs)


def param_shardings(specs: PyTree, mesh) -> PyTree:
    return tree_map(
        lambda s: NamedSharding(mesh, resolve(mesh, s.logical, s.shape)),
        specs)


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


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The gold logit of each position: ``torch.gather``; on a DTensor
    (the vocabulary whole) on this rank's rows, whose backward scatters
    into a zero block of the local shape (DTensor's own gather backward
    makes a zero tensor of the global shape on every rank: 637 GB a
    device in the dry run of qwen3-14b's train_4k cell on 256 ranks)."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, tuple(
            Replicate() if p.is_partial() else p for p in logits.placements))
    rows = tuple(p if isinstance(p, Shard) and p.dim < labels.ndim
                 else Replicate() for p in logits.placements)
    labels = as_dtensor(labels, mesh)
    if tuple(labels.placements) != rows:
        labels = labels.redistribute(mesh, rows)
    gold = torch.gather(logits.to_local(), -1,
                        labels.to_local()[..., None].long())[..., 0]
    return from_local(gold, mesh, rows, labels.shape)


class _SplitVocabCE(torch.autograd.Function):
    """(logsumexp, gold logit) per row of this rank's block of logits
    split over the vocabulary: the block's max, exps and gold logit
    joined by MAX/SUM all-reduces over ``groups`` (the vocabulary's mesh
    dims); the backward is the softmax and the onehot on the block, each
    scaled by its output's grad (``softmax - onehot`` for the mean loss),
    with no collective."""

    @staticmethod
    def forward(ctx, x, labels, lo: int, groups):
        import torch.distributed as dist
        m = torch.amax(x, dim=-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        s = torch.sum(torch.exp(x - m[..., None]), dim=-1)
        for g in groups:
            dist.all_reduce(s, group=g)
        lse = m + torch.log(s)
        idx = labels.long() - lo
        hit = (idx >= 0) & (idx < x.shape[-1])
        idx = torch.where(hit, idx, 0)
        gold = torch.gather(x, -1, idx[..., None])[..., 0]
        gold = torch.where(hit, gold, 0.0)
        for g in groups:
            dist.all_reduce(gold, group=g)
        ctx.save_for_backward(x, lse, idx, hit)
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        x, lse, idx, hit = ctx.saved_tensors
        grad = torch.exp(x - lse[..., None])
        if g_lse is None:
            grad.zero_()
        else:
            grad.mul_(g_lse[..., None])
        if g_gold is not None:
            grad.scatter_add_(-1, idx[..., None],
                              torch.where(hit, g_gold, 0.0)[..., None])
        return grad, None, None, None


def _lse_gold_split(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, gold logit) of a DTensor of logits split over the
    vocabulary (its last dim), Megatron's vocabulary-parallel cross
    entropy: each rank keeps its block, and only (rows,) vectors cross
    ranks.  Both come back split as the logits' rows are."""
    from torch.distributed.tensor import Replicate, Shard
    from ..sharding import block_start, normalized
    mesh, v = logits.device_mesh, logits.ndim - 1
    places = normalized(logits.placements, logits.ndim)
    if any(p.is_partial() for p in places):
        places = tuple(Replicate() if p.is_partial() else p for p in places)
        logits = logits.redistribute(mesh, places)
    vocab = [j for j, p in enumerate(places)
             if isinstance(p, Shard) and p.dim == v]
    rows = tuple(Replicate() if j in vocab else p
                 for j, p in enumerate(places))
    labels = as_dtensor(labels, mesh)
    if normalized(labels.placements, labels.ndim) != rows:
        labels = labels.redistribute(mesh, rows)
    lse, gold = _SplitVocabCE.apply(
        logits.to_local(), labels.to_local(), block_start(logits, v),
        [mesh.get_group(j) for j in vocab])
    return (from_local(lse, mesh, rows, labels.shape),
            from_local(gold, mesh, rows, labels.shape))


def _vocab_split(logits: torch.Tensor) -> bool:
    from torch.distributed.tensor import Shard
    from ..sharding import normalized
    return is_dtensor(logits) and any(
        isinstance(p, Shard) and p.dim == logits.ndim - 1
        for p in normalized(logits.placements, logits.ndim))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE.  logits (..., V) f32; labels (...) int.

    On a mesh, logits split over the vocabulary stay split: the
    logsumexp and the gold logit are joined across the vocabulary's
    ranks (:func:`_lse_gold_split`), as XLA partitions the reference's
    over its ``("dp", None, "tp")`` logits, so no rank holds a row of the
    whole vocabulary.  Logits whose vocabulary is whole take the gold
    logit on each rank's rows (:func:`_gold`)."""
    if _vocab_split(logits):
        lse, gold = _lse_gold_split(logits.float(), labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, labels)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
