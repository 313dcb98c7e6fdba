"""ExecutionPlan: the spec→plan lowering of the PyTorch port.

The counterpart of ``repro.core.plan`` for one device.
``lower(spec, shape, dtype, *, backend, sweeps, tile, device)`` resolves,
once, everything a backend needs — the tap factorization, the
boundary-ghost strategy, the tile, the halo depth and the assembled SPU
program — and memoizes the frozen plan in the process-wide
:data:`PLAN_CACHE`.  ``spec`` is a :class:`StencilSpec` or a
:class:`StencilPipeline`; a pipeline's fetched halo is the per-dim sum of
its stage radii, and a chain that mixes periodic with non-periodic
stages lowers ``fused=False`` to the ``"staged"`` strategy (one
single-sweep stage plan per stage).  The backends are thin executors of
the plan: ``repro_torch.core.ref.execute_plan`` (``"ref"``, the torch
oracle) and ``repro_torch.kernels.engine.execute_plan`` (``"cuda"``, the
hand-written kernels K1-K4 on a CUDA tensor, their plain versions on a
CPU tensor).

Differences from the reference, by design:

* ``interpret`` is replaced by ``device`` (part of the plan key);
* the kernel tile defaults to the first Hopper tile whose two shared
  memory window buffers fit 227 KB (:func:`default_tile`), cut to a grid
  smaller than it (:func:`fit_tile`); ``tile="auto"`` ranks the same
  candidates, each fitted likewise, by the Hopper cost model
  (:mod:`repro_torch.kernels.tune`, counted in
  ``PLAN_CACHE.autotune_calls``); an
  explicit tile that does not fit — or a chain for which no tile fits,
  or whose taps exceed the kernels' argument pools — is refused here, at
  lowering time, on every device;
* ``lax.scan`` over the fused blocks is a Python loop.

What the port does not have yet raises ``NotImplementedError`` naming
its ROADMAP item: grids past the device budget that would stream from
the host (item 7), ``mesh`` (item 9), strict static verification (item
10) and ``backend="vm"`` (item 11).
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
from .isa import assemble, assemble_pipeline
from .stencil import (Factorization, StencilPipeline, StencilSpec, as_stages,
                      factor_taps)

#: The execution layers a plan can target: ``"ref"`` is the torch oracle
#: chain, ``"cuda"`` the fused hand-written kernels.
BACKENDS = ("ref", "cuda")

#: Backends that lower to a fused kernel (resolved tile, ghost strategy).
KERNEL_BACKENDS = ("cuda",)

#: Boundary-ghost strategies a plan can select:
#: ``"pad"`` (oracle: re-extend before every application),
#: ``"pad-free"`` (K1/K3: windows loaded straight from the unpadded grid
#: through the boundary index map), ``"padded-window"`` (K2/K4: windows
#: read from one ``pad_boundary`` copy — grids smaller than one window,
#: and periodic grids past the whole-grid budget) and ``"staged"``
#: (non-fusable pipelines: the chain runs stage by stage through cached
#: single-sweep stage plans, each choosing its own strategy).
GHOST_STRATEGIES = ("pad", "pad-free", "padded-window", "staged")

#: Candidate kernel tiles per rank, largest first.  One CTA owns one
#: tile; the innermost dim is a multiple of the 32-thread warp so loads
#: coalesce.  :func:`default_tile` takes the first whose working set fits
#: one block's shared memory at the plan's ``sweeps`` and itemsize;
#: ``tile="auto"`` ranks them all, each fitted to the grid
#: (:mod:`repro_torch.kernels.tune`), and on an H100 ranked the default
#: first on every main-path case (``tools/tile_probe.py``).  The
#: square 64x64 leads in 2-D: it recomputes less halo than 32x128 (9.9
#: against 10.3 points per output for reaction_diffusion2d at sweeps=4)
#: and still leaves room for two CTAs per SM in f64.  In 3-D a tile is a
#: chunk of ``tile[0]`` planes of an xy tile: a one-stage spec streams
#: the chunk plane by plane (:func:`stream_layout`, whose rings do not
#: depend on ``tile[0]``), so its candidates are the 32-plane chunks
#: first; 32 planes keep the window of a 64-deep grid inside the grid up
#: to ``sweeps*halo = 16`` (the pad-free rule of
#: :func:`ghost_strategy_for`), and a shallower grid gets a shorter chunk
#: (:func:`normalize_tile` with its ``shape``).  A pipeline keeps its 3-D
#: window in shared memory and takes the first of the small boxes that
#: fits.
HOPPER_TILES: dict[int, tuple[tuple[int, ...], ...]] = {
    1: ((4096,), (2048,), (1024,), (512,), (256,), (128,), (32,)),
    2: ((64, 64), (32, 128), (32, 64), (16, 64), (16, 32), (8, 32), (4, 32),
        (1, 32)),
    3: ((32, 32, 32), (32, 16, 32), (32, 16, 16), (32, 8, 16), (32, 8, 8),
        (8, 16, 32), (8, 8, 32), (4, 8, 32), (4, 4, 32), (2, 4, 32),
        (2, 2, 32), (1, 2, 32), (1, 1, 32)),
}

#: ROADMAP items named by what this slice leaves out.
_NOT_PORTED = {
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


def _chunk(itemsize: int) -> int:
    """Elements per 16 bytes of a grid row: the unit of the kernels'
    ``cp.async`` loads and of their shared-memory rows (1 for bf16, which
    is widened to f32 on load and never copied asynchronously)."""
    return 16 // itemsize if itemsize >= 4 else 1


@dataclasses.dataclass(frozen=True)
class KernelLayout:
    """The shared buffers of one K1-K4 CTA, as ``layout_of`` in
    ``csrc/stencil.cu`` builds them (every rank carried as rank 3).

    Buffer 0 holds the window, buffer 1 the intermediates (the first of
    them, the window less stage 0's radius per side, is the largest).
    Both keep the window's row pitch ``row``, so an element at window
    coordinate ``(j0, j1, j2)`` sits at
    ``j0 * plane[b] + j1 * row + j2 + base[b]`` of buffer ``b`` and a tap
    is one linear offset per buffer.  ``row`` rounds ``lead`` plus the
    window's row up to 16 bytes of storage; ``lead`` places every tile's
    first window column at the residue its input column has mod 16 bytes
    (a pad-free window starts ``sweeps*H`` before its tile, a padded one
    on its tile's own column: ``lead`` 0).  A CTA that packs ``pack``
    grids of rank 1 or 2 stacks their windows along dim 0 (extent 1,
    halo 0), one plane each.  ``elems`` counts each buffer's elements
    (buffer 1: 0 when the block is one application)."""

    lead: int
    row: int
    plane: tuple[int, int]
    base: tuple[int, int]
    elems: tuple[int, int]

    def offset(self, b: int, off3: Sequence[int]) -> int:
        """The linear offset in buffer ``b`` of a rank-3 tap offset."""
        return off3[0] * self.plane[b] + off3[1] * self.row + off3[2]


def kernel_layout(tile: Sequence[int], spec, sweeps: int, itemsize: int,
                  *, padded: bool = False, pack: int = 1) -> KernelLayout:
    """The :class:`KernelLayout` of ``spec`` (a spec or a pipeline) at
    ``tile``, ``sweeps`` and the grid's ``itemsize``, for the pad-free or
    the ``padded`` entry and ``pack`` grids per CTA."""
    return _kernel_layout(tuple(tile), spec, sweeps, itemsize, bool(padded),
                          int(pack))


# the layouts and the default tile are asked for on every launch: cached,
# so that a short block does not wait on the host
@functools.lru_cache(maxsize=1024)
def _kernel_layout(tile, spec, sweeps, itemsize, padded,
                   pack) -> KernelLayout:
    stages = as_stages(spec)
    pad = 3 - spec.ndim
    t3 = (1,) * pad + tuple(tile)
    big = (0,) * pad + tuple(spec.halo)
    h = (0,) * pad + tuple(stages[0].halo)
    vec = _chunk(itemsize)
    win = [t + 2 * sweeps * hh for t, hh in zip(t3, big)]
    win[0] *= pack
    lead = 0 if padded else -(sweeps * big[2]) % vec
    row = -(-(lead + win[2]) // vec) * vec
    plane = (win[1] * row, (win[1] - 2 * h[1]) * row)
    base = (lead, lead - h[0] * plane[1] - h[1] * row)
    elems = (win[0] * plane[0],
             (win[0] - 2 * h[0]) * plane[1] if sweeps * len(stages) > 1
             else 0)
    return KernelLayout(lead, row, plane, base, elems)


#: Planes the streamed rank-3 kernel loads ahead of use
#: (``CASPER_STREAM_AHEAD``).
STREAM_AHEAD = 2


def streams(spec) -> bool:
    """Whether K1/K2 run ``spec`` streamed along dim 0 (a rank-3
    :class:`StencilSpec`; pipelines keep the 3-D window)."""
    return spec.ndim == 3 and not isinstance(spec, StencilPipeline)


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """The shared memory of one CTA of the streamed rank-3 kernel, as
    ``stream_geom`` and ``stream_smem_bytes`` in ``csrc/stencil.cu`` lay
    it out.  Level ``l`` (0 the window, ``sweeps - 1`` the last
    intermediate) is a ring of ``depth0`` (level 0: the ``2*h0 + 1``
    planes read, plus :data:`STREAM_AHEAD` in flight) or ``depth``
    (``2*h0 + 2``: the planes read and the one formed meanwhile) planes of
    ``planes[l]`` elements from element ``level_off[l]``; a plane holds
    the level's ``(tile[1] + 2*(sweeps-l)*h1) x row`` box, its first column
    at ``lead``; every level keeps the window's row pitch ``row``, so a
    tap is one in-plane offset ``dy*row + dx`` plus its plane's offset.
    The offset tables follow the rings, 16-byte aligned, for two steps in
    turn: those of stages without register-held taps,
    ``2 * sweeps * (n_taps + n_foff)`` ints, then each level's plane
    offsets, ``2 * sweeps * (2*h0 + 2)`` ints; last, each level's ring
    offset and plane size, ``2 * sweeps`` ints."""

    lead: int
    row: int
    depth0: int
    depth: int
    planes: tuple[int, ...]
    level_off: tuple[int, ...]
    table_bytes: int
    smem: int

    def offset(self, b: int, off3: Sequence[int]) -> int:
        """The in-plane offset of a tap's dims 1 and 2 (dim 0 goes by
        plane; ``b`` is unused)."""
        return off3[1] * self.row + off3[2]


def n_factor_offsets(spec) -> int:
    """Factor offsets over ``spec``'s stages' factored terms."""
    total = 0
    for st in as_stages(spec):
        terms = (None if st.structure == "dense"
                 else st.factorization.compute_terms)
        for term in terms or ():
            total += sum(len(f.offsets) for f in term.factors)
    return total


def stream_layout(tile: Sequence[int], spec, sweeps: int,
                  itemsize: int) -> StreamLayout:
    """The :class:`StreamLayout` of a rank-3 spec at ``tile``, ``sweeps``
    and the grid's ``itemsize``."""
    return _stream_layout(tuple(tile), spec, sweeps, itemsize)


@functools.lru_cache(maxsize=1024)
def _stream_layout(tile, spec, sweeps, itemsize) -> StreamLayout:
    h = spec.halo
    vec = _chunk(itemsize)
    lead = -(sweeps * h[2]) % vec
    row = -(-(lead + tile[2] + 2 * sweeps * h[2]) // vec) * vec
    depth = 2 * h[0] + 2
    planes = tuple((tile[1] + 2 * (sweeps - lvl) * h[1]) * row
                   for lvl in range(sweeps))
    offs = [0]
    for lvl, pl in enumerate(planes):
        offs.append(offs[-1] + (depth - 1 + STREAM_AHEAD if lvl == 0
                                else depth) * pl)
    table_bytes = -(-offs[-1] * max(itemsize, 4) // 16) * 16
    smem = table_bytes + 8 * sweeps * (spec.n_taps + n_factor_offsets(spec)
                                       + depth + 1)
    return StreamLayout(lead, row, depth - 1 + STREAM_AHEAD, depth, planes,
                        tuple(offs[:-1]), table_bytes, smem)


def smem_bytes(tile: Sequence[int], spec, sweeps: int, itemsize: int,
               *, padded: bool = False, pack: int = 1) -> int:
    """Shared memory one CTA of K1-K4 needs for ``spec`` (a spec or a
    pipeline): for a rank-3 spec, the streamed kernel's rings and tables
    (:func:`stream_layout`); else the two buffers of
    :func:`kernel_layout` — the fetched window ``tile + 2*sweeps*H``
    (``H`` the sum of the stage radii) and, when
    ``sweeps * n_stages > 1``, the intermediate buffer, both on the
    window's 16-byte-rounded row pitch, ``pack`` times over for a CTA of
    ``pack`` grids.  Both hold the accumulator type: an element of a grid
    narrower than f32 takes 4 bytes there."""
    if streams(spec):
        return stream_layout(tile, spec, sweeps, itemsize).smem
    return sum(kernel_layout(tile, spec, sweeps, itemsize, padded=padded,
                             pack=pack).elems) * max(itemsize, 4)


#: Largest ``gridDim.x`` of a launch.
MAX_BLOCKS = 2 ** 31 - 1


def launch_blocks(out_shape: Sequence[int], tile: Sequence[int],
                  batch: int, pack: int = 1) -> int:
    """CTAs of one K1-K4 launch, as ``launch_blocks`` in
    ``csrc/stencil.cu`` counts them: every tile of every group of
    ``pack`` batch elements, all on ``gridDim.x``, so a batch is not held
    to ``gridDim.y``'s 65,535.  Raises ``ValueError`` past
    :data:`MAX_BLOCKS`."""
    blocks = -(-batch // pack) * math.prod(-(-n // t)
                                           for n, t in zip(out_shape, tile))
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{blocks} CTAs (batch {batch} x tiles of "
                         f"{tuple(out_shape)} by {tuple(tile)}) exceed one "
                         f"launch's {MAX_BLOCKS}")
    return blocks


def load_path(shape: Sequence[int], tile: Sequence[int], itemsize: int,
              data_ptr: int = 0, *, padded: bool = False) -> str:
    """How a launch copies the windows that need no boundary test, fixed
    before the launch from its input's ``shape`` (the grid, or for the
    ``padded`` entry the pre-padded window), the tile, the dtype and the
    alignment: ``"async"`` (16-byte ``cp.async``) for an f32/f64 input
    whose rows are whole 16-byte chunks, whose tile's row is a whole
    number of chunks (so every window starts on the layout's ``lead``)
    and whose data starts 16-byte aligned; otherwise, for the padded
    entry, ``"elem"`` (a 4- or 8-byte ``cp.async`` per element) in
    f32/f64, and ``"plain"`` (element by element through registers,
    bf16 widened on the way).  The windows it covers: a pad-free
    launch's interior tiles, and a padded launch's tiles whose window
    lies inside its input (all but the ragged end).  Every other tile
    loads element by element, mapped (pad-free) or masked (padded)."""
    vec = _chunk(itemsize)
    if itemsize < 4:
        return "plain"
    if shape[-1] % vec or tile[-1] % vec or data_ptr % 16:
        return "elem" if padded else "plain"
    return "async"


#: Threads of one K1-K4 CTA (``CASPER_THREADS``).
CTA_THREADS = 256

#: CTAs per SM the kernels' register budget leaves room for
#: (``CASPER_MIN_BLOCKS``): packed windows are held to the shared memory
#: that keeps this many resident.
CTAS_PER_SM = 2


def pack_factor(spec, out_shape: Sequence[int], tile: Sequence[int],
                sweeps: int, itemsize: int, batch: int, *,
                padded: bool = False) -> int:
    """How many grids of a batch one CTA of the window kernel carries,
    chosen at launch (a plan does not depend on its batch size).  Only a
    spec or pipeline of rank 1 or 2 whose tile covers the whole output
    packs: its ``P`` windows are stacked along the spare dim 0, so every
    tap keeps its linear offset and one box walk covers all of them.
    ``P`` is at most what keeps :data:`CTAS_PER_SM` CTAs resident in an
    SM's shared memory.  The card holds 132 SMs x :data:`CTAS_PER_SM`
    CTAs at once (a wave): at that cap the batch takes ``W`` waves, and
    ``P`` is the fewest grids per CTA that still finish in ``W`` (so the
    last wave is as full as the others, and a batch smaller than a wave
    fills the card), but at least as many as give each of the
    :data:`CTA_THREADS` threads a point of the last application; never
    more than the batch."""
    return _pack_factor(spec, tuple(out_shape), tuple(tile), sweeps,
                        itemsize, batch, bool(padded))


# asked for on every launch: cached, as the layouts are
@functools.lru_cache(maxsize=1024)
def _pack_factor(spec, out_shape, tile, sweeps, itemsize, batch,
                 padded) -> int:
    if (spec.ndim == 3 or batch < 2
            or any(t < n for t, n in zip(tile, out_shape))):
        return 1
    per = smem_bytes(tile, spec, sweeps, itemsize, padded=padded)
    budget = (_pm.H100_SMEM_PER_SM // CTAS_PER_SM
              - _pm.H100_SMEM_RESERVED_PER_BLOCK)
    cap = budget // per
    if cap < 2:
        return 1
    wave = _pm.H100_SMS * CTAS_PER_SM
    waves = -(-batch // (cap * wave))
    need = -(-CTA_THREADS // math.prod(tile))
    return min(max(-(-batch // (waves * wave)), need), cap, batch)


@functools.lru_cache(maxsize=1024)
def default_tile(spec, sweeps: int = 1, itemsize: int = 4
                 ) -> tuple[int, ...]:
    """The first :data:`HOPPER_TILES` entry whose working set
    (:func:`smem_bytes`) fits one block's shared memory."""
    for tile in HOPPER_TILES[spec.ndim]:
        if smem_bytes(tile, spec, sweeps,
                      itemsize) <= _pm.H100_SMEM_PER_BLOCK:
            return tile
    raise ValueError(
        f"{spec.name}: no Hopper tile fits {_pm.H100_SMEM_PER_BLOCK} bytes "
        f"of shared memory at sweeps={sweeps}, itemsize={itemsize}; "
        "lower sweeps")


def fit_tile(spec, tile: Sequence[int], sweeps: int, itemsize: int,
             shape: Sequence[int]) -> tuple[int, ...]:
    """``tile`` fitted to an output of ``shape``: a streamed spec's chunk
    ``tile[0]`` is first cut to the grid's depth less the window's
    ``2*sweeps*halo[0]`` planes (when that leaves at least one), so the
    window stays inside a shallow grid and the grid pad-free; then every
    dim longer than the output's is cut to it, the row rounded up to the
    layout's 16-byte chunk (so the ``lead`` rule and the ``cp.async``
    path still hold), and the kernel stages the grid's own window instead
    of a larger tile's.  The default tile and every ``tile="auto"``
    candidate are fitted by this rule (``spec=None``: no chunk cut)."""
    tile = tuple(tile)
    if spec is not None and streams(spec):
        fit = shape[-3] - 2 * sweeps * spec.halo[0]
        if 1 <= fit < tile[0]:
            tile = (fit,) + tile[1:]
    vec = _chunk(itemsize)
    return tuple(min(t, n) for t, n in zip(tile[:-1], shape[:-1])) \
        + (min(tile[-1], -(-shape[-1] // vec) * vec),)


def normalize_tile(spec: StencilSpec, tile: Sequence[int] | int | None,
                   sweeps: int = 1, itemsize: int = 4,
                   shape: Sequence[int] | None = None) -> tuple[int, ...]:
    """Default / int-promote / validate a kernel tile for ``spec``.  The
    default tile is fitted to an output of ``shape`` (:func:`fit_tile`).
    An explicit ``tile`` is taken as it is; ``"auto"`` is resolved once
    per plan by :func:`lower`, never here."""
    if tile is None:
        tile = default_tile(spec, sweeps, itemsize)
        return tile if shape is None else fit_tile(spec, tile, sweeps,
                                                   itemsize, shape)
    if tile == "auto":
        raise ValueError("tile='auto' is resolved by plan.lower (the "
                         "autotuner, repro_torch.kernels.tune); pass the "
                         "resolved tile here")
    if isinstance(tile, int):
        tile = (tile,)
    tile = tuple(int(t) for t in tile)
    if len(tile) != spec.ndim:
        raise ValueError(f"tile rank {len(tile)} != spec ndim {spec.ndim}")
    if any(t < 1 for t in tile):
        raise ValueError(f"tile {tile} must be positive")
    return tile


def _check_tile_fits(spec, tile, sweeps, itemsize) -> None:
    need = smem_bytes(tile, spec, sweeps, itemsize)
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
    """Pad-free (K1/K3) vs padded-window (K2/K4), the rule of
    ``repro.core.plan.ghost_strategy_for``: a grid smaller than one fetch
    window in any dim takes the padded window; a periodic grid takes it
    when its bytes exceed ``periodic_budget_bytes`` (default
    :data:`repro_torch.core.perfmodel.PERIODIC_WHOLE_GRID_BYTES`, the
    device memory: K1 takes every periodic grid).  A fusable pipeline
    takes the same rule: its ``halo`` is the sum of the stage radii and
    its mode is periodic only when every stage is.

    Small grids stay on the padded window by measurement: on an H100,
    with fitted tiles and several grids per CTA on both entries, K1/K3
    on the unpadded grids did not beat the host pad plus K2/K4 on every
    batch of small grids (``tools/window_probe.py``: batches of 8x8
    grids ran faster padded, of (512,) grids pad-free)."""
    shape = tuple(shape)
    tile = normalize_tile(spec, tile, sweeps, itemsize, shape)
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
    ``sweeps`` stencil (or stage-chain) applications — resolved once at
    lowering time."""

    spec: StencilSpec | StencilPipeline
    shape: tuple[int, ...]              # global grid shape
    dtype: str                          # canonical dtype name
    backend: str                        # one of BACKENDS
    sweeps: int
    device: str                         # canonical torch device string
    tile: tuple[int, ...] | None        # resolved output tile (cuda only)
    tile_request: object                # what was asked: tuple/None
    ghost_strategy: str                 # one of GHOST_STRATEGIES
    halo: tuple[int, ...]               # per application (pipelines: sum)
    deep_halo: tuple[int, ...]          # sweeps * halo, per dim
    factorization: Factorization | None  # pinned f64 order (None: pipeline,
                                         # each stage keeps its own)
    boundary_mode: str                  # pipelines: stage 0's
    boundary_value: float
    program: object                     # isa.Program / PipelineProgram
    fused: bool = True                  # False: non-fusable pipeline,
                                        # executed stage plan by stage plan

    @property
    def stream_plan(self):
        """The assembled stream plan (``program.plan``)."""
        return self.program.plan

    @property
    def is_pipeline(self) -> bool:
        return isinstance(self.spec, StencilPipeline)

    @property
    def stages(self) -> tuple[StencilSpec, ...]:
        """The stage chain: the pipeline's stages, or ``(spec,)``."""
        return as_stages(self.spec)

    def stage_plan(self, k: int) -> "ExecutionPlan":
        """The single-sweep plan of stage ``k`` (same shape, dtype,
        backend, tile request and device), lowered through the cache —
        what the staged fallback executes."""
        return lower(self.stages[k], self.shape, self.dtype,
                     backend=self.backend, sweeps=1, tile=self.tile_request,
                     device=self.device)

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
    ``misses``, ``lowers``, ``autotune_calls`` — the tile autotunes
    lowering ran for ``tile="auto"`` — and ``evictions``)."""

    def __init__(self, maxsize: int = 512):
        self.maxsize = maxsize
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.lowers = 0
        self.autotune_calls = 0
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
        """Atomic miss → lower → insert under the cache lock (the
        counters, and any autotune the factory runs, included)."""
        with self._lock:
            hit = self.get(key)
            if hit is not None:
                return hit
            self.lowers += 1
            plan = factory()
            _verify_new_plan(plan)
            self.put(key, plan)
            return plan

    def keys(self):
        """Current keys, least- to most-recently used."""
        with self._lock:
            return list(self._store)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._store),
                "maxsize": self.maxsize,
                "hits": self.hits,
                "misses": self.misses,
                "lowers": self.lowers,
                "autotune_calls": self.autotune_calls,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0,
            }

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = self.misses = self.lowers = 0
            self.autotune_calls = self.evictions = 0


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
    """Hashable canonical form of a tile request: ``"auto"``, ``None`` or
    a tuple of ints."""
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
def lower(spec: StencilSpec | StencilPipeline, shape: Sequence[int], dtype,
          *, backend: str = "ref", sweeps: int = 1,
          tile: Sequence[int] | int | None = None,
          device=None, mesh=None, grid_axes=None) -> ExecutionPlan:
    """Lower ``(spec, shape, dtype, …)`` to an :class:`ExecutionPlan`,
    through the process-wide :data:`PLAN_CACHE`."""
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
    dev = canonical_device(device)
    key = plan_key(spec, shape, dtype, backend, sweeps, tile_req, dev)
    return PLAN_CACHE.get_or_lower(
        key, lambda: _lower_uncached(spec, shape, canonical_dtype(dtype),
                                     backend, sweeps, tile_req, dev))


def _lower_uncached(spec, shape, dtype, backend, sweeps, tile_req,
                    device) -> ExecutionPlan:
    """One plan for a spec or a pipeline.  A pipeline's halo is the sum
    of its stage radii and its initial extension is stage 0's; a chain
    that is not fusable lowers ``fused=False`` with strategy
    ``"staged"``, and its stage plans decide everything else.  Runs only
    from :meth:`PlanCache.get_or_lower`, so ``autotune_calls`` counts
    under the cache lock."""
    halo = spec.halo
    deep = tuple(sweeps * h for h in halo)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if math.prod(shape) * itemsize > _pm.slab_budget_bytes():
        raise not_ported("stream")
    pipeline = isinstance(spec, StencilPipeline)
    fused = spec.fusable if pipeline else True

    resolved_tile = None
    ghost = "pad" if fused else "staged"        # oracle default
    if backend in KERNEL_BACKENDS and fused:
        if tile_req == "auto":
            # the shape tuned for: the grid's (slab streaming, item 7,
            # will pass its slab's here)
            tune_shape = shape
            from ..kernels import tune as _tune
            PLAN_CACHE.autotune_calls += 1
            autotune = _tune.autotune_pipeline if pipeline else _tune.autotune
            resolved_tile = autotune(spec, tune_shape, sweeps=sweeps,
                                     itemsize=itemsize,
                                     backend=backend).tile
        else:
            resolved_tile = normalize_tile(spec, tile_req, sweeps, itemsize,
                                           shape)
        _check_tile_fits(spec, resolved_tile, sweeps, itemsize)
        from ..kernels import engine as _keng
        _keng.check_kernel_args(spec)
        ghost = ghost_strategy_for(spec, shape, itemsize, sweeps,
                                   resolved_tile)

    return ExecutionPlan(
        spec=spec, shape=shape, dtype=dtype_name(dtype), backend=backend,
        sweeps=sweeps, device=device, tile=resolved_tile,
        tile_request=tile_req, ghost_strategy=ghost, halo=halo,
        deep_halo=deep,
        factorization=None if pipeline else factor_taps(spec),
        boundary_mode=spec.boundary_mode,
        boundary_value=spec.boundary_value,
        program=assemble_pipeline(spec) if pipeline else assemble(spec),
        fused=fused)


# ---------------------------------------------------------------------------
# Execution: thin dispatch to the backend executors
# ---------------------------------------------------------------------------
def execute(plan: ExecutionPlan, grid: torch.Tensor) -> torch.Tensor:
    """One fused block — ``plan.sweeps`` applications — on the plan's
    backend (an optional leading batch dim is one more launch axis).  A
    non-fusable pipeline plan runs its chain through the cached
    single-sweep stage plans instead: chained semantics, per-stage
    traffic."""
    if not plan.fused:
        out = grid
        for _ in range(plan.sweeps):
            for k in range(len(plan.stages)):
                out = execute(plan.stage_plan(k), out)
        return out
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


def _grid_shape_for(spec, grid) -> tuple[int, ...]:
    """The per-grid shape to lower for: ``grid`` may carry one leading
    batch dimension."""
    if grid.ndim == spec.ndim + 1:
        return tuple(grid.shape[1:])
    return tuple(grid.shape)


@functools.lru_cache(maxsize=512)
def runner(spec, backend: str, sweeps: int, tile_req,
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


def runner_cache_stats() -> dict:
    """Hit/miss counters of the runner cache (a hit: a second engine
    re-used the first's callable), beside the plan cache's
    ``autotune_calls``.  The reference's ``batch_runner`` waits for
    serving (ROADMAP Queue 1 item 8)."""
    return {"runner": runner.cache_info()._asdict(),
            "autotune_calls": PLAN_CACHE.stats()["autotune_calls"]}
