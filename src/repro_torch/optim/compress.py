"""Gradient compression with error feedback for the data-parallel reduce.

int8 block-quantized gradients (absmax per block of 256) cut the
all-reduce volume 4x against f32 (2x against bf16); the quantization
residual is carried in a per-leaf error-feedback buffer, so the
compression is unbiased over time (EF-SGD / 1-bit Adam lineage).  The
trainer applies it to the gradient tree before the update.  Every op here
is exactly rounded, so the port matches the reference bit for bit in f32.
"""
from __future__ import annotations

from typing import Any

import torch

from ..models.common import tree_leaves, tree_map

QBLOCK = 256


def init_error(params: Any) -> Any:
    """Zero f32 error-feedback buffers shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device),
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


@torch.no_grad()
def compress_tree(grads: Any, err: Any) -> tuple[Any, Any]:
    """Round-trips every leaf of ``grads`` through int8 with error
    feedback; returns (the dequantized grads in each leaf's dtype, the new
    errors).  The error buffers are updated in place and returned."""
    outs = []
    for g, e in zip(tree_leaves(grads, torch.is_tensor),
                    tree_leaves(err, torch.is_tensor)):
        q, s, ne = compress_leaf(g, e)
        outs.append(decompress_leaf(q, s, g.shape).to(g.dtype))
        e.copy_(ne)
    it = iter(outs)
    return tree_map(lambda _: next(it), grads, torch.is_tensor), err
