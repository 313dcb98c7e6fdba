"""Dense feed-forward variants: SwiGLU / GeGLU / squared-ReLU / GELU.

The activation runs in float32 and is cast back to the activations'
dtype before the product with ``up`` (or with ``w_out``), as in the
reference.  On a mesh the gated products run one per half of ``w_in``:
flattening its (2, d_ff) with d_ff sharded has no DTensor view (torch
2.11 refuses it).  One device keeps the reference's one product over the
flattened weight: split there, the backward adds the two halves' input
grads in bfloat16, and qwen3's grads part from the reference's op by op
past the 0.1% of a leaf's largest that tests/test_torch_train_rounding.py
allows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import ShardCtx, is_dtensor
from .common import PSpec

GATED = {"swiglu", "geglu"}


def mlp_param_specs(d_model: int, d_ff: int, act: str) -> dict[str, PSpec]:
    if act in GATED:
        return {
            "w_in": PSpec((d_model, 2, d_ff), ("fsdp", None, "tp")),
            "w_out": PSpec((d_ff, d_model), ("tp", "fsdp")),
        }
    return {
        "w_in": PSpec((d_model, d_ff), ("fsdp", "tp")),
        "w_out": PSpec((d_ff, d_model), ("tp", "fsdp")),
    }


def gated_in(x: torch.Tensor, w_in: torch.Tensor, ctx: ShardCtx,
             *axes: str | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(gate, up): ``x`` against the two halves of ``w_in`` (d, 2, f),
    each constrained to the logical ``axes`` where they are given.  On a
    mesh one product per half, on one device one product over the
    flattened weight (see the module's docstring)."""
    if is_dtensor(w_in):
        gate, up = (x @ w_in[:, z] for z in (0, 1))
        if axes:
            gate, up = (ctx.constrain(t, *axes) for t in (gate, up))
        return gate, up
    h = (x @ w_in.reshape(w_in.shape[0], -1)).unflatten(-1, w_in.shape[1:])
    if axes:
        h = ctx.constrain(h, *axes[:-1], None, axes[-1])
    return h[..., 0, :], h[..., 1, :]


def mlp(p: dict, x: torch.Tensor, act: str, ctx: ShardCtx) -> torch.Tensor:
    if act in GATED:
        gate, up = gated_in(x, p["w_in"], ctx, "dp", None, "tp")
        if act == "swiglu":
            h = F.silu(gate.float()).to(x.dtype) * up
        else:
            h = F.gelu(gate.float(), approximate="tanh").to(x.dtype) * up
    else:
        h = ctx.constrain(x @ p["w_in"], "dp", None, "tp")
        if act == "sqrelu":
            r = F.relu(h.float())
            h = (r * r).to(x.dtype)
        elif act == "gelu":
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        else:
            raise ValueError(f"unknown act {act}")
    return ctx.constrain(h @ p["w_out"], "dp", None, None)
