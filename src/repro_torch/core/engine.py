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

Backends: ``"ref"`` (the torch oracle chain), ``"cuda"`` (the fused
hand-written kernels K1-K4; on a CPU device their plain versions run)
and ``"vm"`` (the software SPU, :mod:`repro_torch.core.vm`, in torch on
the engine's device).  A grid whose block would not fit the device
budget (``CASPER_SLAB_BUDGET``, default the H100's 80 GB; the block's
input, output and any padded copy count) stays on the host and streams
through the device in slabs (:mod:`repro_torch.kernels.stream`); so does
a batch whose blocks fit one grid at a time but not together, which then
runs on the device a part of the batch at a time.  ``run`` then returns
a CPU tensor.
``tile=None`` takes the default Hopper tile, fitted to a small grid;
``tile="auto"`` ranks the candidate tiles by the Hopper cost model once
per plan (:mod:`repro_torch.kernels.tune`,
``CasperEngine(spec, backend="cuda", sweeps=4, tile="auto")``); an
explicit tile is taken as it is.
``device=None`` means ``"cuda"`` and raises where CUDA is missing; pass
``device="cpu"`` to run on the host.  The engine is frozen after
``__init__``.

``engine.distributed_fn(mesh, ("sx", "sy"), iters=10)`` runs the same
configuration on a ``torch.distributed`` ``DeviceMesh``: every rank calls
the returned function on its own shard (:mod:`repro_torch.core.halo`).
"""
from __future__ import annotations

import functools
from typing import Literal, Sequence

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

    def step(self, grid) -> torch.Tensor:
        """One fused block: ``self.sweeps`` stencil applications (on the
        host, slab by slab, for a grid past the budget, as :meth:`run`)."""
        plan, g = _plan.place(self.spec, grid, self.backend, self.sweeps,
                              _plan.canonical_tile_request(self.tile),
                              _plan.canonical_device(self.device))
        return _plan.execute(plan, g)

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
        result is a tensor on the engine's device.

        A grid whose block would not fit the device budget is never
        copied to the device whole: it streams from the host in slabs,
        and the result is a CPU tensor (in pinned memory on a CUDA
        engine).  A CUDA tensor past the budget is first copied to the
        host.  ``CASPER_SLAB_BUDGET`` (bytes) lowers the budget, which
        forces streaming on a grid that would fit.  The budget holds for
        the whole batch: a batch whose grids fit one at a time but not
        together stays on the host and runs a part at a time, its result
        a CPU tensor too."""
        return self._run(grid, iters)

    def analyze(self, shape: Sequence[int], dtype=None, *,
                sweeps: int | None = None, lint: bool = True):
        """The static analysis of the plan this engine uses for ``shape``
        (``dtype`` defaults to float32): the invariant catalog (run, and
        cached, when the plan was lowered) and, when ``lint``, the launch
        lint (dtype contract, FMA contraction, fused vs staged bytes,
        launches).  See :mod:`repro_torch.analysis`."""
        from .. import analysis
        if dtype is None:
            dtype = torch.float32
        plan = self.plan_for(shape, dtype, sweeps=sweeps)
        return analysis.analyze_plan(plan, lint=lint)

    _INHERIT = object()   # tile sentinel: None is itself a legal tile

    def distributed_fn(self, mesh, grid_axes: Sequence[str | None],
                       iters: int = 1, *, sweeps: int | None = None,
                       backend: str | None = None, tile=_INHERIT):
        """A function that maps this rank's shard to this rank's shard
        after ``iters`` applications on ``mesh`` (a ``DeviceMesh``; see
        :func:`repro_torch.core.halo.distributed_stencil_fn`), on the
        engine's device.  It takes the engine's ``sweeps``, ``backend``
        and ``tile`` unless the call overrides them, so temporal blocking
        (one deep halo exchange, then fused shard-local sweeps on K2/K4)
        applies as in :meth:`run`, and ``iters`` decomposes as
        ``q*sweeps + r`` the same way."""
        from .halo import distributed_stencil_fn
        return distributed_stencil_fn(
            self.spec, mesh, grid_axes, iters,
            sweeps=self.sweeps if sweeps is None else sweeps,
            backend=self.backend if backend is None else backend,
            tile=self.tile if tile is CasperEngine._INHERIT else tile,
            device=self.device)

    # Casper API surface (Table 1), as thin documentation shims -------------
    def init_stencil_segment(self, size_bytes: int) -> SegmentConfig:
        return SegmentConfig(mapping="blocked")

    def init_stencilcode(self) -> tuple[int, ...]:
        return self.program.words
