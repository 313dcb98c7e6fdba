"""Batched LM serving: prefill once, then decode step by step on the KV
caches, which each step updates in place.

On a ``DeviceMesh`` (every rank of the world builds its own engine and
makes the same calls) the params are DTensors, TP-only (replicated over
``dp``) where the config says ``serve_params_tp_only``; each batch is
sharded over ``dp``, and the logits are gathered whole for sampling, so
every rank draws the same tokens.  It runs under ``no_grad`` there: a
DTensor view of a param under ``inference_mode`` fails ("Cannot set
version_counter for inference tensor")."""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from ..models.common import place_params, tree_leaves, tree_map
from ..models.registry import ArchDef
from ..sharding import ShardCtx, full_tensor, is_dtensor


class ServeEngine:
    """Serves ``arch`` with ``params`` on ``device`` (``None``: the card;
    raises where CUDA is missing).  Params elsewhere are copied there; on
    ``mesh``, params that are not DTensors yet (whole in every rank) are
    placed by their specs."""

    def __init__(self, arch: ArchDef, params: Any, mesh=None,
                 max_len: int = 512, device=None):
        self.arch = arch
        self.cfg = arch.cfg
        overrides = ({"fsdp": None} if self.cfg.serve_params_tp_only
                     else None)
        self.ctx = ShardCtx(mesh, overrides=overrides)
        self.max_len = max_len
        self.device = resolve_device(device)
        params = tree_map(lambda t: t if is_dtensor(t) else t.to(self.device),
                          params, is_leaf=torch.is_tensor)
        if mesh is not None and not any(
                is_dtensor(t) for t in tree_leaves(params, torch.is_tensor)):
            params = place_params(params, arch.param_specs(self.cfg), mesh,
                                  overrides)
        self.params = params

    def generate(self, batch: dict, n_tokens: int, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Greedy/temperature sampling; returns (B, n_tokens) int32.

        The first token samples from the prefill logits; the remaining
        ``n_tokens - 1`` come from exactly that many decode steps (no
        trailing wasted decode).  With a temperature every sample draws
        fresh noise from ``generator`` (default: seed 0 on the engine's
        device), so no two samples share random numbers.
        """
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        cfg, ctx = self.cfg, self.ctx
        mode = torch.no_grad if ctx.mesh is not None else \
            torch.inference_mode
        with mode():
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            batch = {k: ctx.place(v, "dp", *([None] * (v.ndim - 1)))
                     for k, v in batch.items()}
            state, length, logits = self.arch.prefill(
                self.params, batch, cfg, ctx, max_len=self.max_len)
            tok = self._sample(full_tensor(logits)[:, -1], temperature,
                               generator)
            outs = [tok]
            for _ in range(n_tokens - 1):
                state, length, logits = self.arch.decode(
                    self.params, state, length, ctx.place(tok, "dp", None),
                    cfg, ctx)
                tok = self._sample(full_tensor(logits)[:, -1], temperature,
                                   generator)
                outs.append(tok)
            return torch.cat(outs, dim=-1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        """argmax (the first index among equal maxima), or a Gumbel-max
        draw from ``softmax(logits / temperature)``."""
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits / temperature + gumbel,
                            dim=-1).to(torch.int32)[:, None]
