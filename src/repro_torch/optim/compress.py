"""Gradient compression with error feedback for the data-parallel reduce.

int8 block-quantized gradients (absmax per block of 256) cut the
all-reduce volume 4x against f32 (2x against bf16); the quantization
residual is carried in a per-leaf error-feedback buffer, so the
compression is unbiased over time (EF-SGD / 1-bit Adam lineage).  The
trainer applies it to the gradient tree before the update.  Every op here
is exactly rounded, so the port matches the reference bit for bit in f32.

On a mesh the grads and the error buffers are DTensors in the params'
placements.  The blocks run over the logically global flattened leaf, as
in the reference: each rank compresses its rows of the leaf (every dim
but the first whole) where the rows of every rank start on a block
boundary, and the whole leaf otherwise (a DTensor flatten of a sharded
inner dim has no form); the new error goes back to the buffer's
placements.
"""
from __future__ import annotations

from typing import Any

import torch

from ..models.common import tree_leaves, tree_map
from ..sharding import from_local, is_dtensor, on_mesh

QBLOCK = 256


def init_error(params: Any) -> Any:
    """Zero f32 error-feedback buffers shaped (and on a mesh, placed)
    like ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params, torch.is_tensor)


def compress_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + err -> (q int8 (blocks, 256), scale (blocks, 1), new_err)."""
    x = g.detach().to(torch.float32) + err
    flat = x.reshape(-1)
    pad = -flat.shape[0] % QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1, keepdim=True)
                        / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    new_err = x - decompress_leaf(q, scale, x.shape)
    return q, scale, new_err


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple[int, ...]) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def _row_layout(e) -> tuple:
    """Placements under which each rank's block of ``e`` is a run of
    whole 256-blocks of its flattened leaf: its rows (dim 0 sharded as
    it is, every other dim whole) where the rows divide evenly into
    block-aligned runs, else the leaf whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = e.device_mesh
    rows = [mesh.size(j) for j, pl in enumerate(e.placements)
            if isinstance(pl, Shard) and pl.dim == 0]
    n = 1
    for r in rows:
        n *= r
    inner = e.numel() // max(e.shape[0], 1) if e.ndim else 1
    aligned = (e.ndim > 0 and e.shape[0] % n == 0
               and (e.shape[0] // n) * inner % QBLOCK == 0)
    return tuple(pl if aligned and isinstance(pl, Shard) and pl.dim == 0
                 else Replicate() for pl in e.placements)


def _compress_on_mesh(g, e):
    mesh = e.device_mesh
    lay = _row_layout(e)
    gl = g.redistribute(mesh, lay).to_local()
    el = e.redistribute(mesh, lay).to_local()
    q, s, ne = compress_leaf(gl, el)
    out = decompress_leaf(q, s, gl.shape).to(g.dtype)
    return (from_local(out, mesh, lay).redistribute(mesh, e.placements),
            from_local(ne, mesh, lay).redistribute(mesh, e.placements))


@torch.no_grad()
def compress_tree(grads: Any, err: Any) -> tuple[Any, Any]:
    """Round-trips every leaf of ``grads`` through int8 with error
    feedback; returns (the dequantized grads in each leaf's dtype, the new
    errors).  The error buffers are updated in place and returned."""
    outs = []
    with on_mesh():
        for g, e in zip(tree_leaves(grads, torch.is_tensor),
                        tree_leaves(err, torch.is_tensor)):
            if is_dtensor(e):
                out, ne = _compress_on_mesh(g, e)
            else:
                q, s, ne = compress_leaf(g, e)
                out = decompress_leaf(q, s, g.shape).to(g.dtype)
            outs.append(out)
            e.copy_(ne)
    it = iter(outs)
    return tree_map(lambda _: next(it), grads, torch.is_tensor), err
