"""CasperEngine: the user-facing stencil runtime of the PyTorch port.

    engine = CasperEngine(jacobi2d(), backend="cuda", sweeps=4)
    out    = engine.run(grid, iters=100)       # a tensor on the card

The counterpart of ``repro.core.engine.CasperEngine``, a thin front over
the plan lowering (:mod:`repro_torch.core.plan`): the first time a grid
shape is seen, ``plan.lower`` resolves the factorization, the ghost
strategy, the tile and the program once and caches the plan; ``run``
then executes ``iters = q*sweeps + r`` as ``q`` fused blocks plus one
narrower remainder block.  A second engine with identical options reuses
the same runner and plans (zero re-lowers).

``spec`` is a :class:`StencilSpec` or a :class:`StencilPipeline`:

    engine = CasperEngine(PAPER_PIPELINES["reaction_diffusion2d"],
                          backend="cuda", sweeps=4)

runs ``sweeps`` applications of the whole stage chain per fused block
(K3/K4), or, for a chain that mixes periodic with non-periodic stages,
one single-sweep K1/K2 launch per stage.

Backends: ``"ref"`` (the torch oracle chain) and ``"cuda"`` (the fused
hand-written kernels K1-K4; on a CPU device their plain versions run).
``tile=None`` takes the default Hopper tile, fitted to a small grid;
``tile="auto"`` ranks the candidate tiles by the Hopper cost model once
per plan (:mod:`repro_torch.kernels.tune`,
``CasperEngine(spec, backend="cuda", sweeps=4, tile="auto")``); an
explicit tile is taken as it is.
``device=None`` means ``"cuda"`` and raises where CUDA is missing; pass
``device="cpu"`` to run on the host.  The engine is frozen after
``__init__``.
"""
from __future__ import annotations

import functools
from typing import Literal, Sequence

import numpy as np
import torch

from . import plan as _plan
from .isa import assemble_any
from .segment import SegmentConfig
from .stencil import StencilPipeline, StencilSpec


def resolve_device(device) -> torch.device:
    """``None`` → ``cuda``.  A CUDA device where CUDA is missing raises:
    the engine never falls back to the host on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CasperEngine: CUDA is not available; pass device='cpu' to run "
            "on the host")
    return dev


class CasperEngine:
    def __init__(
        self,
        spec: StencilSpec | StencilPipeline,
        backend: str = "ref",
        segment: SegmentConfig | None = None,
        device=None,
        sweeps: int = 1,
        tile: Sequence[int] | Literal["auto"] | None = None,
    ):
        if sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {sweeps}")
        if backend == "vm":
            raise _plan.not_ported("vm")
        if backend not in _plan.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.spec = spec
        self.backend = backend
        self.segment = segment or SegmentConfig()
        self.device = resolve_device(device)
        self.sweeps = sweeps
        self.tile = tile
        self.program = assemble_any(spec)
        self._frozen = True

    def __setattr__(self, name, value):
        # run() delegates to a process-wide runner keyed on the init-time
        # options; mutating them afterwards would silently keep running
        # stale fused blocks.
        if getattr(self, "_frozen", False):
            raise AttributeError(
                f"CasperEngine is frozen; cannot set {name!r} after init — "
                "construct a new engine instead")
        super().__setattr__(name, value)

    def plan_for(self, shape: Sequence[int], dtype,
                 sweeps: int | None = None) -> _plan.ExecutionPlan:
        """The (cached) execution plan this engine uses for ``shape``."""
        return _plan.lower(
            self.spec, shape, dtype, backend=self.backend,
            sweeps=self.sweeps if sweeps is None else sweeps,
            tile=self.tile, device=self.device)

    def _on_device(self, grid) -> torch.Tensor:
        if isinstance(grid, np.ndarray):
            grid = torch.from_numpy(np.ascontiguousarray(grid))
        return grid.to(self.device).contiguous()

    def step(self, grid) -> torch.Tensor:
        """One fused block: ``self.sweeps`` stencil applications."""
        g = self._on_device(grid)
        return _plan.execute(
            self.plan_for(_plan._grid_shape_for(self.spec, g), g.dtype), g)

    @functools.cached_property
    def _run(self):
        # Process-wide: a second engine with identical options gets the
        # same runner (and, through it, the same cached plans).
        return _plan.runner(self.spec, self.backend, self.sweeps,
                            _plan.canonical_tile_request(self.tile),
                            _plan.canonical_device(self.device))

    def run(self, grid, iters: int = 1) -> torch.Tensor:
        """``iters`` total stencil applications (fused ``sweeps`` at a
        time, plus one narrower remainder block).  ``grid`` is a numpy
        array or a tensor, optionally with one leading batch dim; the
        result is a tensor on the engine's device."""
        return self._run(self._on_device(grid), iters)

    def analyze(self, *args, **kwargs):
        raise _plan.not_ported("verify")

    def distributed_fn(self, *args, **kwargs):
        raise _plan.not_ported("mesh")

    # Casper API surface (Table 1), as thin documentation shims -------------
    def init_stencil_segment(self, size_bytes: int) -> SegmentConfig:
        return SegmentConfig(mapping="blocked")

    def init_stencilcode(self) -> tuple[int, ...]:
        return self.program.words
