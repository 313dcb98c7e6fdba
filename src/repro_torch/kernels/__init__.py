"""Hand-written CUDA kernels of the PyTorch port and their wrappers.

Kernels are built from ``csrc/`` at first use (``_build``), never at
import.  The per-rank ``stencil1d/2d/3d`` of the reference's seed are
deprecated shims over the plan-driven engine, as in ``repro.kernels``:
new code calls ``engine.stencil_apply``, goes through
:class:`repro_torch.core.engine.CasperEngine`, or lowers a plan and
hands it to ``engine.execute_plan``.
"""
import warnings

from . import engine, ops, ref, tune
from .engine import (LAUNCHES, execute_plan, hbm_pipeline_traffic,
                     hbm_traffic, pipeline_apply, pipeline_sweep,
                     pipeline_sweep_plain, pipeline_window_sweep,
                     pipeline_window_sweep_plain, reset_launches, run_sweeps,
                     stencil_apply, stencil_sweep, stencil_sweep_plain,
                     stencil_window_sweep, stencil_window_sweep_plain)
from .swa import (sliding_window_attention, sliding_window_attention_plain,
                  swa_ref)
from .tune import autotune, autotune_measured


def _legacy_rank_shim(rank: int, spec, grid, tile):
    warnings.warn(
        f"repro_torch.kernels.stencil{rank}d is deprecated; use "
        "kernels.engine.stencil_apply / CasperEngine (the per-rank seed "
        "kernels were folded into the plan-driven engine)",
        DeprecationWarning, stacklevel=3)
    from ..core import plan as _plan
    p = _plan.lower(spec, grid.shape, grid.dtype, backend="cuda", tile=tile,
                    device=grid.device)
    return _plan.execute(p, grid)


def stencil1d(spec, grid, tile: int = 512):
    """DEPRECATED shim for the seed's 1-D kernel (one sweep)."""
    return _legacy_rank_shim(1, spec, grid, (tile,))


def stencil2d(spec, grid, tile=(32, 256)):
    """DEPRECATED shim for the seed's 2-D kernel (one sweep)."""
    return _legacy_rank_shim(2, spec, grid, tile)


def stencil3d(spec, grid, tile=(4, 16, 128)):
    """DEPRECATED shim for the seed's 3-D kernel (one sweep)."""
    return _legacy_rank_shim(3, spec, grid, tile)


__all__ = [
    "LAUNCHES", "autotune", "autotune_measured", "engine", "execute_plan",
    "hbm_pipeline_traffic", "hbm_traffic", "ops", "pipeline_apply",
    "pipeline_sweep", "pipeline_sweep_plain", "pipeline_window_sweep",
    "pipeline_window_sweep_plain", "ref", "reset_launches", "run_sweeps",
    "sliding_window_attention", "sliding_window_attention_plain",
    "stencil1d", "stencil2d", "stencil3d", "stencil_apply", "stencil_sweep",
    "stencil_sweep_plain", "stencil_window_sweep",
    "stencil_window_sweep_plain", "swa_ref", "tune",
]
