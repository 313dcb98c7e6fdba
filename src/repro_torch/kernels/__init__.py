"""Hand-written CUDA kernels of the PyTorch port and their wrappers.

Kernels are built from ``csrc/`` at first use (``_build``), never at
import.
"""
from .engine import (LAUNCHES, execute_plan, hbm_traffic, reset_launches,
                     stencil_apply, stencil_sweep, stencil_sweep_plain,
                     stencil_window_sweep, stencil_window_sweep_plain)

__all__ = [
    "LAUNCHES", "execute_plan", "hbm_traffic", "reset_launches",
    "stencil_apply", "stencil_sweep", "stencil_sweep_plain",
    "stencil_window_sweep", "stencil_window_sweep_plain",
]
