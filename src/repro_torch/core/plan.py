"""ExecutionPlan: the spec→plan lowering of the PyTorch port.

The counterpart of ``repro.core.plan`` for one device and one spec.
``lower(spec, shape, dtype, *, backend, sweeps, tile, device)`` resolves,
once, everything a backend needs — the tap factorization, the
boundary-ghost strategy, the tile, the halo depth and the assembled SPU
program — and memoizes the frozen plan in the process-wide
:data:`PLAN_CACHE`.  The backends are thin executors of the plan:
``repro_torch.core.ref.execute_plan`` (``"ref"``, the torch oracle) and
``repro_torch.kernels.engine.execute_plan`` (``"cuda"``, the
hand-written kernels K1/K2 on a CUDA tensor, their plain versions on a
CPU tensor).

Differences from the reference, by design:

* ``interpret`` is replaced by ``device`` (part of the plan key);
* the kernel tile defaults to the first Hopper tile whose two shared
  memory window buffers fit 227 KB (:func:`default_tile`), and an
  explicit tile that does not fit is refused here, at lowering time;
* ``lax.scan`` over the fused blocks is a Python loop.

What this slice does not port raises ``NotImplementedError`` naming its
ROADMAP item: pipelines (item 5), ``tile="auto"`` (item 6), grids past
the device budget that would stream from the host (item 7), ``mesh``
(item 9), strict static verification (item 10) and ``backend="vm"``
(item 11).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from . import perfmodel as _pm
from .isa import assemble
from .stencil import Factorization, StencilPipeline, StencilSpec, factor_taps

#: The execution layers a plan can target: ``"ref"`` is the torch oracle
#: chain, ``"cuda"`` the fused hand-written kernels.
BACKENDS = ("ref", "cuda")

#: Backends that lower to a fused kernel (resolved tile, ghost strategy).
KERNEL_BACKENDS = ("cuda",)

#: Boundary-ghost strategies a plan of this slice can select:
#: ``"pad"`` (oracle: re-extend before every application),
#: ``"pad-free"`` (K1: windows loaded straight from the unpadded grid
#: through the boundary index map) and ``"padded-window"`` (K2: windows
#: read from one ``pad_boundary`` copy — tiny grids, and periodic grids
#: past the whole-grid budget).
GHOST_STRATEGIES = ("pad", "pad-free", "padded-window")

#: Candidate kernel tiles per rank, largest first.  One CTA owns one
#: tile; the innermost dim is a multiple of the 32-thread warp so loads
#: coalesce.  :func:`default_tile` takes the first whose working set fits
#: one block's shared memory at the plan's ``sweeps`` and itemsize.
HOPPER_TILES: dict[int, tuple[tuple[int, ...], ...]] = {
    1: ((4096,), (2048,), (1024,), (512,), (256,), (128,), (32,)),
    2: ((32, 128), (32, 64), (16, 64), (16, 32), (8, 32), (4, 32),
        (1, 32)),
    3: ((8, 16, 32), (8, 8, 32), (4, 8, 32), (4, 4, 32), (2, 4, 32),
        (2, 2, 32), (1, 2, 32), (1, 1, 32)),
}

#: ROADMAP items named by what this slice leaves out.
_NOT_PORTED = {
    "pipeline": "StencilPipeline plans (fused pipelines, kernels K3/K4): "
                "ROADMAP Queue 1 item 5",
    "auto": "tile='auto' (the autotuner): ROADMAP Queue 1 item 6",
    "stream": "grids past the device budget (stream-from-host slab "
              "streaming): ROADMAP Queue 1 item 7",
    "mesh": "distributed plans (mesh / deep halo exchange): ROADMAP "
            "Queue 1 item 9",
    "verify": "the static plan verifier: ROADMAP Queue 1 item 10",
    "vm": "backend='vm' (the software SPU): ROADMAP Queue 1 item 11",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"not yet ported to repro_torch: {_NOT_PORTED[what]}")


def smem_bytes(tile: Sequence[int], halo: Sequence[int], sweeps: int,
               itemsize: int) -> int:
    """Shared memory one CTA of K1/K2 needs: the fetched window
    ``tile + 2*sweeps*halo`` plus, when ``sweeps > 1``, the ping-pong
    buffer of the first intermediate (one halo layer narrower)."""
    win = [t + 2 * sweeps * h for t, h in zip(tile, halo)]
    total = math.prod(win)
    if sweeps > 1:
        total += math.prod(w - 2 * h for w, h in zip(win, halo))
    return total * itemsize


def default_tile(spec: StencilSpec, sweeps: int = 1,
                 itemsize: int = 4) -> tuple[int, ...]:
    """The first :data:`HOPPER_TILES` entry whose working set
    (:func:`smem_bytes`) fits one block's shared memory."""
    for tile in HOPPER_TILES[spec.ndim]:
        if smem_bytes(tile, spec.halo, sweeps,
                      itemsize) <= _pm.H100_SMEM_PER_BLOCK:
            return tile
    raise ValueError(
        f"{spec.name}: no Hopper tile fits {_pm.H100_SMEM_PER_BLOCK} bytes "
        f"of shared memory at sweeps={sweeps}, itemsize={itemsize}; "
        "lower sweeps")


def normalize_tile(spec: StencilSpec, tile: Sequence[int] | int | None,
                   sweeps: int = 1, itemsize: int = 4) -> tuple[int, ...]:
    """Default / int-promote / validate a kernel tile for ``spec``."""
    if tile is None:
        return default_tile(spec, sweeps, itemsize)
    if tile == "auto":
        raise not_ported("auto")
    if isinstance(tile, int):
        tile = (tile,)
    tile = tuple(int(t) for t in tile)
    if len(tile) != spec.ndim:
        raise ValueError(f"tile rank {len(tile)} != spec ndim {spec.ndim}")
    if any(t < 1 for t in tile):
        raise ValueError(f"tile {tile} must be positive")
    return tile


def _check_tile_fits(spec, tile, sweeps, itemsize) -> None:
    need = smem_bytes(tile, spec.halo, sweeps, itemsize)
    if need > _pm.H100_SMEM_PER_BLOCK:
        raise ValueError(
            f"{spec.name}: tile {tile} at sweeps={sweeps} needs {need} "
            f"bytes of shared memory per block; Hopper allows "
            f"{_pm.H100_SMEM_PER_BLOCK}")


# ---------------------------------------------------------------------------
# The decision (single home; backends only consume the answer)
# ---------------------------------------------------------------------------
def ghost_strategy_for(spec: StencilSpec, shape: Sequence[int],
                       itemsize: int, sweeps: int,
                       tile: Sequence[int] | int | None,
                       *, periodic_budget_bytes: int | None = None) -> str:
    """Pad-free (K1) vs padded-window (K2), the rule of
    ``repro.core.plan.ghost_strategy_for``: a grid smaller than one fetch
    window in any dim takes the padded window; a periodic grid takes it
    when its bytes exceed ``periodic_budget_bytes`` (default
    :data:`repro_torch.core.perfmodel.PERIODIC_WHOLE_GRID_BYTES`, a
    quarter of the H100's L2)."""
    tile = normalize_tile(spec, tile, sweeps, itemsize)
    shape = tuple(shape)
    wide = tuple(sweeps * h for h in spec.halo)
    win = tuple(t + 2 * w for t, w in zip(tile, wide))
    if spec.boundary_mode == "periodic":
        if periodic_budget_bytes is None:
            periodic_budget_bytes = _pm.PERIODIC_WHOLE_GRID_BYTES
        grid_bytes = math.prod(shape) * itemsize
        return ("padded-window" if grid_bytes > periodic_budget_bytes
                else "pad-free")
    if any(w > n for w, n in zip(win, shape)):
        return "padded-window"
    return "pad-free"


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything a backend needs to execute one fused block of
    ``sweeps`` stencil applications — resolved once at lowering time."""

    spec: StencilSpec
    shape: tuple[int, ...]              # global grid shape
    dtype: str                          # canonical dtype name
    backend: str                        # one of BACKENDS
    sweeps: int
    device: str                         # canonical torch device string
    tile: tuple[int, ...] | None        # resolved output tile (cuda only)
    tile_request: object                # what was asked: tuple/None
    ghost_strategy: str                 # one of GHOST_STRATEGIES
    halo: tuple[int, ...]
    deep_halo: tuple[int, ...]          # sweeps * halo, per dim
    factorization: Factorization        # pinned f64 order
    boundary_mode: str
    boundary_value: float
    program: object                     # assembled isa.Program

    @property
    def stream_plan(self):
        """The assembled stream plan (``program.plan``)."""
        return self.program.plan

    def decompose(self, iters: int) -> tuple[int, int]:
        """``iters = q * sweeps + r``."""
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        return divmod(iters, self.sweeps)

    def remainder(self, r: int) -> "ExecutionPlan":
        """The plan for a narrower fused block of ``r`` sweeps, lowered
        through the cache (same spec/shape/backend/tile request)."""
        return lower(self.spec, self.shape, self.dtype,
                     backend=self.backend, sweeps=r, tile=self.tile_request,
                     device=self.device)


# ---------------------------------------------------------------------------
# The process-wide plan cache
# ---------------------------------------------------------------------------
class PlanCache:
    """LRU cache of lowered plans with observable counters (``hits``,
    ``misses``, ``lowers`` and ``evictions``)."""

    def __init__(self, maxsize: int = 512):
        self.maxsize = maxsize
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.lowers = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def get(self, key):
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key]
            self.misses += 1
            return None

    def put(self, key, plan) -> None:
        with self._lock:
            self._store[key] = plan
            self._store.move_to_end(key)
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)
                self.evictions += 1

    def get_or_lower(self, key, factory):
        """Atomic miss → lower → insert under the cache lock."""
        with self._lock:
            hit = self.get(key)
            if hit is not None:
                return hit
            self.lowers += 1
            plan = factory()
            _verify_new_plan(plan)
            self.put(key, plan)
            return plan

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._store),
                "maxsize": self.maxsize,
                "hits": self.hits,
                "misses": self.misses,
                "lowers": self.lowers,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0,
            }

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = self.misses = self.lowers = self.evictions = 0


#: Environment switch of the reference's plan verifier (``off`` /
#: ``warn`` / ``strict``).
VERIFY_ENV = "CASPER_VERIFY"


def _verify_new_plan(plan) -> None:
    """The reference statically verifies each new plan.  The port has no
    verifier yet, so a caller who demands it (``CASPER_VERIFY=strict``)
    gets an error instead of an unverified plan."""
    if os.environ.get(VERIFY_ENV, "warn") == "strict":
        raise not_ported("verify")


#: The process-wide plan cache, shared by every engine.
PLAN_CACHE = PlanCache()


def plan_cache_stats() -> dict:
    return PLAN_CACHE.stats()


def canonical_tile_request(tile) -> object:
    """Hashable canonical form of a tile request: ``None`` or a tuple of
    ints (``"auto"`` passes through to be refused by :func:`lower`)."""
    if tile is None or tile == "auto":
        return tile
    if isinstance(tile, int):
        return (int(tile),)
    return tuple(int(t) for t in tile)


def canonical_device(device) -> str:
    """``torch.device`` string of ``device`` (``None`` → ``"cuda"``)."""
    return str(torch.device("cuda" if device is None else device))


def canonical_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, numpy dtype or name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    out = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def dtype_name(dtype) -> str:
    return str(canonical_dtype(dtype)).replace("torch.", "")


def plan_key(spec: StencilSpec, shape, dtype, backend: str, sweeps: int,
             tile, device) -> tuple:
    """The plan-cache key: the full spec (boundary + structure ride on
    spec equality), shape, dtype, backend, sweeps, the tile *request*,
    the device and the slab budget."""
    return (spec, tuple(int(n) for n in shape), dtype_name(dtype),
            backend, int(sweeps), canonical_tile_request(tile),
            canonical_device(device), _pm.slab_budget_bytes())


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------
def lower(spec: StencilSpec, shape: Sequence[int], dtype, *,
          backend: str = "ref", sweeps: int = 1,
          tile: Sequence[int] | int | None = None,
          device=None, mesh=None, grid_axes=None) -> ExecutionPlan:
    """Lower ``(spec, shape, dtype, …)`` to an :class:`ExecutionPlan`,
    through the process-wide :data:`PLAN_CACHE`."""
    if isinstance(spec, StencilPipeline):
        raise not_ported("pipeline")
    if mesh is not None or grid_axes is not None:
        raise not_ported("mesh")
    if backend == "vm":
        raise not_ported("vm")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    shape = tuple(int(n) for n in shape)
    if len(shape) != spec.ndim:
        raise ValueError(f"shape rank {len(shape)} != spec ndim {spec.ndim}")
    tile_req = canonical_tile_request(tile)
    if tile_req == "auto":
        raise not_ported("auto")
    dev = canonical_device(device)
    key = plan_key(spec, shape, dtype, backend, sweeps, tile_req, dev)
    return PLAN_CACHE.get_or_lower(
        key, lambda: _lower_uncached(spec, shape, canonical_dtype(dtype),
                                     backend, sweeps, tile_req, dev))


def _lower_uncached(spec, shape, dtype, backend, sweeps, tile_req,
                    device) -> ExecutionPlan:
    halo = spec.halo
    deep = tuple(sweeps * h for h in halo)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if math.prod(shape) * itemsize > _pm.slab_budget_bytes():
        raise not_ported("stream")

    resolved_tile = None
    ghost = "pad"                               # oracle default
    if backend in KERNEL_BACKENDS:
        resolved_tile = normalize_tile(spec, tile_req, sweeps, itemsize)
        _check_tile_fits(spec, resolved_tile, sweeps, itemsize)
        ghost = ghost_strategy_for(spec, shape, itemsize, sweeps,
                                   resolved_tile)

    return ExecutionPlan(
        spec=spec, shape=shape, dtype=dtype_name(dtype), backend=backend,
        sweeps=sweeps, device=device, tile=resolved_tile,
        tile_request=tile_req, ghost_strategy=ghost, halo=halo,
        deep_halo=deep, factorization=factor_taps(spec),
        boundary_mode=spec.boundary_mode,
        boundary_value=spec.boundary_value, program=assemble(spec))


# ---------------------------------------------------------------------------
# Execution: thin dispatch to the backend executors
# ---------------------------------------------------------------------------
def execute(plan: ExecutionPlan, grid: torch.Tensor) -> torch.Tensor:
    """One fused block — ``plan.sweeps`` applications — on the plan's
    backend (an optional leading batch dim is one more launch axis)."""
    if plan.backend == "ref":
        from . import ref as _ref
        return _ref.execute_plan(plan, grid)
    if plan.backend == "cuda":
        from ..kernels import engine as _keng
        return _keng.execute_plan(plan, grid)
    raise ValueError(f"unknown backend {plan.backend!r}")


def run_plan(plan: ExecutionPlan, grid: torch.Tensor,
             iters: int) -> torch.Tensor:
    """``iters`` total applications under ``plan``: ``q`` fused blocks in
    a Python loop plus one narrower remainder block whose plan comes from
    the cache.  ``iters == 0`` returns a copy of the input, never the
    input itself (the reference's contract, ``plan.py:773-776``)."""
    q, r = plan.decompose(iters)
    if iters == 0:
        return grid.clone()
    out = grid
    for _ in range(q):
        out = execute(plan, out)
    if r:
        out = execute(plan.remainder(r), out)
    return out


def _grid_shape_for(spec: StencilSpec, grid) -> tuple[int, ...]:
    """The per-grid shape to lower for: ``grid`` may carry one leading
    batch dimension."""
    if grid.ndim == spec.ndim + 1:
        return tuple(grid.shape[1:])
    return tuple(grid.shape)


@functools.lru_cache(maxsize=512)
def runner(spec: StencilSpec, backend: str, sweeps: int, tile_req,
           device: str):
    """Process-wide ``run(grid, iters)`` for an engine configuration: a
    second engine with identical options gets the same callable, and
    every plan it needs comes from :data:`PLAN_CACHE`."""
    def run(grid: torch.Tensor, iters: int) -> torch.Tensor:
        plan = lower(spec, _grid_shape_for(spec, grid), grid.dtype,
                     backend=backend, sweeps=sweeps, tile=tile_req,
                     device=device)
        return run_plan(plan, grid, iters)
    return run
