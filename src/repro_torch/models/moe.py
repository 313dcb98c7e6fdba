"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch.

GShard-style group-local dispatch, as the reference computes it: tokens
are split into ``n_groups`` contiguous groups; each group scatters its
tokens into per-expert capacity buffers (one overflow slot per expert,
dropped), the experts run as one batched product, and results gather
back weighted by their renormalised router probabilities.

Aux losses: load-balance (Switch) + router z-loss.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..sharding import ShardCtx
from .common import PSpec


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # shared (always-on) experts, qwen2-moe style
    capacity_factor: float = 1.25
    n_groups: int = 32           # dispatch groups; align to DP shards
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    # pad the expert dim (the reference: to a multiple of the EP axis);
    # padded experts get -1e30 router logits and are never selected
    pad_experts_to: int = 0

    @property
    def n_experts_padded(self) -> int:
        return max(self.n_experts, self.pad_experts_to)


def moe_param_specs(d_model: int, m: MoeCfg) -> dict[str, PSpec]:
    e, f = m.n_experts_padded, m.d_expert
    p = {
        "router": PSpec((d_model, e), ("fsdp", None), dtype=torch.float32),
        "w_gate": PSpec((e, d_model, f), ("ep", "fsdp", None)),
        "w_up": PSpec((e, d_model, f), ("ep", "fsdp", None)),
        "w_down": PSpec((e, f, d_model), ("ep", None, "fsdp")),
    }
    if m.n_shared:
        fs = m.n_shared * f
        p["shared_w_in"] = PSpec((d_model, 2, fs), ("fsdp", None, "tp"))
        p["shared_w_out"] = PSpec((fs, d_model), ("tp", "fsdp"))
        p["shared_gate"] = PSpec((d_model, 1), ("fsdp", None))
    return p


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last dim, the lower
    index first among equal values (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: dict, x: torch.Tensor, m: MoeCfg, ctx: ShardCtx
            ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (y, aux) with aux = {load_balance, z_loss}."""
    b, s, d = x.shape
    n = b * s
    g = min(m.n_groups, n)
    while n % g:
        g -= 1
    ng = n // g                               # tokens per group
    xt = ctx.constrain(x.reshape(g, ng, d), "dp", None, None)

    logits = torch.einsum("gnd,de->gne", xt.float(), p["router"].float())
    e = m.n_experts_padded
    if e > m.n_experts:
        logits = torch.where(torch.arange(e, device=x.device) >= m.n_experts,
                             -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, m.top_k)                     # (g, ng, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # aux losses
    me = torch.mean(probs, dim=(0, 1))                        # mean prob
    experts = torch.arange(e, device=x.device)
    ce = torch.mean(torch.sum((top_e[..., None] == experts).float(), dim=2),
                    dim=(0, 1)) / m.top_k
    load_balance = e * torch.sum(me * ce)
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.mean(z ** 2)
    aux = {"load_balance": load_balance, "z_loss": z_loss,
           "aux_total": (m.aux_loss_weight * load_balance
                         + m.z_loss_weight * z_loss)}

    # group-local capacity dispatch
    cap = int(m.capacity_factor * ng * m.top_k / e)
    cap = max(cap, m.top_k)
    flat_e = top_e.reshape(g, ng * m.top_k)                   # (g, A)
    onehot = (flat_e[..., None] == experts).long()            # (g, A, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.sum(pos * onehot, dim=-1)                    # (g, A)
    keep = slot < cap
    slot = torch.where(keep, slot, cap)                       # overflow bin

    # scatter tokens (duplicated per assignment) into (g, E, cap+1, D)
    xa = torch.repeat_interleave(xt, m.top_k, dim=1)          # (g, A, D)
    buf = torch.zeros((g, e, cap + 1, d), dtype=xt.dtype, device=x.device)
    gi = torch.arange(g, device=x.device)[:, None].expand_as(flat_e)
    buf.index_put_((gi, flat_e, slot), xa, accumulate=True)
    buf = buf[:, :, :cap]                                     # drop overflow

    # expert computation (SwiGLU), one batched product per weight
    hg = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    hu = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    h = F.silu(hg.float()).to(x.dtype) * hu
    yb = torch.einsum("gecf,efd->gecd", h, p["w_down"])

    # gather back, weight, combine over k
    yb = F.pad(yb, (0, 0, 0, 1))                              # overflow -> 0
    ya = yb[gi, flat_e, slot]                                 # (g, A, D)
    ya = ya * (top_w.reshape(g, ng * m.top_k, 1).to(ya.dtype)
               * keep[..., None])
    y = torch.sum(ya.reshape(g, ng, m.top_k, d), dim=2)

    if m.n_shared:
        hshared = torch.einsum("gnd,dzf->gnzf", xt, p["shared_w_in"])
        gate, up = hshared[:, :, 0], hshared[:, :, 1]
        hs = F.silu(gate.float()).to(x.dtype) * up
        ys = torch.einsum("gnf,fd->gnd", hs, p["shared_w_out"])
        sg = torch.sigmoid(torch.einsum("gnd,dz->gnz", xt.float(),
                                        p["shared_gate"].float()))
        y = y + ys * sg.to(y.dtype)

    return y.reshape(b, s, d), aux
