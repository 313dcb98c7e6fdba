"""Parameter and FLOP counts of a model configuration.

The reference's roofline also places a compiled XLA module against TPU
v5e's rates; that part reads XLA's ``cost_analysis`` and is not ported.
These counts carry no hardware constants: ``chip_smoke.py`` sets them
against the card's data-sheet rates.
"""
from __future__ import annotations

from typing import Any

from ..models.config import ModelConfig


def n_params(cfg: ModelConfig) -> float:
    """Total parameter count, from the arch's PSpec tree."""
    from ..models import make_arch
    from ..models.common import param_count
    arch = make_arch(cfg)
    return float(param_count(arch.param_specs(cfg)))


def n_active_params(cfg: ModelConfig) -> float:
    """Parameters a token touches: MoE's unrouted experts left out."""
    total = n_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    expert = 3 * cfg.d_model * m.d_expert       # gate+up+down per expert
    inactive = cfg.n_layers * (m.n_experts - m.top_k) * expert
    return total - inactive


def model_flops(cfg: ModelConfig, cell: Any) -> float:
    """6 * N_active * D for training; 2 * N_active * D for inference."""
    n = n_active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n * tokens
