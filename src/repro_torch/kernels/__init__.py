"""Hand-written CUDA kernels of the PyTorch port and their wrappers.

Kernels are built from ``csrc/`` at first use (``_build``), never at
import.
"""
from . import ops
from .engine import (LAUNCHES, execute_plan, hbm_pipeline_traffic,
                     hbm_traffic, pipeline_apply, pipeline_sweep,
                     pipeline_sweep_plain, pipeline_window_sweep,
                     pipeline_window_sweep_plain, reset_launches,
                     stencil_apply, stencil_sweep, stencil_sweep_plain,
                     stencil_window_sweep, stencil_window_sweep_plain)
from .swa import (sliding_window_attention, sliding_window_attention_plain,
                  swa_ref)

__all__ = [
    "LAUNCHES", "execute_plan", "hbm_pipeline_traffic", "hbm_traffic",
    "ops", "pipeline_apply", "pipeline_sweep", "pipeline_sweep_plain",
    "pipeline_window_sweep", "pipeline_window_sweep_plain",
    "reset_launches", "sliding_window_attention",
    "sliding_window_attention_plain", "stencil_apply", "stencil_sweep",
    "stencil_sweep_plain", "stencil_window_sweep",
    "stencil_window_sweep_plain", "swa_ref",
]
