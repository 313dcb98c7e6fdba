"""Dense feed-forward variants: SwiGLU / GeGLU / squared-ReLU / GELU.

The activation runs in float32 and is cast back to the activations'
dtype before the product with ``up`` (or with ``w_out``), as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import ShardCtx
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


def mlp(p: dict, x: torch.Tensor, act: str, ctx: ShardCtx) -> torch.Tensor:
    d = x.shape[-1]
    if act in GATED:
        w_in = p["w_in"]
        h = (x @ w_in.reshape(d, -1)).unflatten(-1, w_in.shape[1:])
        h = ctx.constrain(h, "dp", None, None, "tp")
        gate, up = h[..., 0, :], h[..., 1, :]
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
