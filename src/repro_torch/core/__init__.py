"""Casper core of the PyTorch port: specs, torch oracle, plans, the
software SPU, engine."""
from .stencil import (StencilSpec, StencilPipeline, PAPER_STENCILS,
                      PAPER_PIPELINES, DOMAIN_SIZES, jacobi1d,
                      jacobi2d, seven_point_1d, blur2d, heat3d, star33_3d,
                      advect1d, advect2d, reaction_diffusion2d,
                      advect_diffuse2d, as_stages, domain_for, parse_boundary,
                      BOUNDARY_MODES, STRUCTURES, factor_taps,
                      Factorization, FactorTerm, AxisKernel)
from .ref import apply_stencil, run_iterations, pad_boundary
from .plan import (ExecutionPlan, PLAN_CACHE, PlanCache, lower,
                   plan_cache_stats, execute, run_plan, ghost_strategy_for)
from .streams import plan_streams, StreamPlan
from .isa import (assemble, assemble_pipeline, assemble_any, decode, Instr,
                  Program, PipelineProgram)
from .segment import SegmentConfig, access_counts, remote_fraction
from .vm import SpuVM, run_program
from .halo import (distributed_stencil_fn, exchange_halo_1axis, gather_grid,
                   shard_grid, sharding_for)
from .engine import CasperEngine

__all__ = [
    "StencilSpec", "StencilPipeline", "PAPER_STENCILS", "PAPER_PIPELINES",
    "DOMAIN_SIZES", "jacobi1d", "jacobi2d",
    "seven_point_1d", "blur2d", "heat3d", "star33_3d", "advect1d",
    "advect2d", "reaction_diffusion2d", "advect_diffuse2d", "as_stages",
    "domain_for", "parse_boundary", "BOUNDARY_MODES",
    "STRUCTURES", "factor_taps", "Factorization", "FactorTerm", "AxisKernel",
    "apply_stencil", "run_iterations", "pad_boundary",
    "plan_streams", "StreamPlan",
    "assemble", "assemble_pipeline", "assemble_any", "decode", "Instr",
    "Program", "PipelineProgram", "SpuVM", "run_program",
    "SegmentConfig", "access_counts", "remote_fraction", "CasperEngine",
    "ExecutionPlan", "PLAN_CACHE", "PlanCache", "lower", "plan_cache_stats",
    "execute", "run_plan", "ghost_strategy_for", "distributed_stencil_fn",
    "exchange_halo_1axis", "sharding_for", "shard_grid", "gather_grid",
]
