"""Public wrappers for the port's kernels (``repro.kernels.ops``).

No jit and no ``interpret`` argument: the tensor's device decides — the
plain PyTorch versions on the CPU, the CUDA kernels on the card.
"""
from __future__ import annotations

import torch

from ..core.stencil import StencilSpec
from . import engine
from .swa import sliding_window_attention


def stencil_apply(spec: StencilSpec, grid: torch.Tensor, tile=None,
                  sweeps: int = 1) -> torch.Tensor:
    """``sweeps`` fused applications of ``spec`` under ``spec.boundary``
    (K1, or K2 where the plan's ghost strategy asks for a padded
    window); accepts an optional leading batch dimension."""
    return engine.stencil_apply(spec, grid, tile=tile, sweeps=sweeps)


def swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
        tq: int = 128, softcap: float | None = None) -> torch.Tensor:
    """Windowed-causal GQA attention (K5): q ``(B, Hq, S, D)``, k/v
    ``(B, Hkv, S, D)``; the output is ``(B, Hq, S, D)`` in q's dtype."""
    return sliding_window_attention(q, k, v, window, tq=tq, softcap=softcap)
