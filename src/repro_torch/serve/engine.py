"""Batched LM serving: prefill once, then decode step by step on the KV
caches, which each step updates in place."""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from ..models.common import tree_map
from ..models.registry import ArchDef
from ..sharding import ShardCtx


class ServeEngine:
    """Serves ``arch`` with ``params`` on ``device`` (``None``: the card;
    raises where CUDA is missing).  Params elsewhere are copied there."""

    def __init__(self, arch: ArchDef, params: Any, mesh=None,
                 max_len: int = 512, device=None):
        self.arch = arch
        self.cfg = arch.cfg
        self.ctx = ShardCtx(mesh)
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params,
                               is_leaf=torch.is_tensor)

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
        with torch.inference_mode():
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            state, length, logits = self.arch.prefill(
                self.params, batch, cfg, ctx, max_len=self.max_len)
            tok = self._sample(logits[:, -1], temperature, generator)
            outs = [tok]
            for _ in range(n_tokens - 1):
                state, length, logits = self.arch.decode(
                    self.params, state, length, tok, cfg, ctx)
                tok = self._sample(logits[:, -1], temperature, generator)
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
