"""ExecutionPlan: the spec→plan lowering of the PyTorch port.

The counterpart of ``repro.core.plan``.
``lower(spec, shape, dtype, *, backend, sweeps, tile, device)`` resolves,
once, everything a backend needs — the tap factorization, the
boundary-ghost strategy, the tile, the halo depth, the slab cover of a
grid past the device budget and the assembled SPU program — and
memoizes the frozen plan in the process-wide :data:`PLAN_CACHE`.
``spec`` is a :class:`StencilSpec` or a :class:`StencilPipeline`; a
pipeline's fetched halo is the per-dim sum of
its stage radii, and a chain that mixes periodic with non-periodic
stages lowers ``fused=False`` to the ``"staged"`` strategy (one
single-sweep stage plan per stage).  The backends are thin executors of
the plan: ``repro_torch.core.ref.execute_plan`` (``"ref"``, the torch
oracle), ``repro_torch.kernels.engine.execute_plan`` (``"cuda"``, the
hand-written kernels K1-K4 on a CUDA tensor, their plain versions on a
CPU tensor), ``repro_torch.core.vm.execute_plan`` (``"vm"``, the
software SPU on the tensor's device) and, for a grid past the device
budget, ``repro_torch.kernels.stream.execute_plan`` (the slab executor:
the grid stays on the host and streams through the device in slabs on
K2/K4 or the oracle's window core).

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
* ``lax.scan`` over the fused blocks is a Python loop;
* the in-core decision charges a block's whole device set against the
  budget (``perfmodel.incore_resident_bytes``): the input, the output
  and, where the block pads (K2/K4's ``pad_boundary`` copy, or the
  oracle's per-application pad), the padded copy; the oracle
  (``"ref"``) also its temporaries and a staged chain its block's input
  (:func:`incore_device_bytes`).  The reference charges the grid alone
  (``plan.py:558``), so a grid between half the budget and the budget
  was judged to fit and ran the card out of memory.  A grid past it
  streams; the slabs' resident set is the port executor's
  (``perfmodel.slab_resident_bytes``: rings of two windows and two
  outputs, and the oracle window core's temporaries).  The decision is
  the plan's alone: the runner lowers once and places the grid by it
  (:func:`place`), frees its own device copy once the first block has
  read it (:func:`run_owned`), and charges a leading batch whole
  (:func:`stays_on_host`: a batch that fits one grid at a time but not
  together runs in core a part at a time).

``mesh`` + ``grid_axes`` lower a distributed plan: a
``torch.distributed.device_mesh.DeviceMesh`` whose named dims shard the
grid dims ``grid_axes`` names (``None``: not sharded).  The plan records
each rank's ``shard_shape``, the per-axis exchange strategy
(:func:`exchange_strategy_for`) and the mesh's fingerprint (in the key);
its shard-local block always reads the exchanged window
(``"padded-window"``: K2/K4 for ``"cuda"``) and never streams, and
:func:`execute` hands it to :mod:`repro_torch.core.halo`.  A
:class:`~repro_torch.sharding.MeshShape` in place of the mesh lowers the
same plan with no process group, to be read and not run (the dry run,
``launch/dryrun.py``; ``tile="auto"`` needs the ranks).

Every new plan is statically verified before it enters the cache
(:mod:`repro_torch.analysis`): ``CASPER_VERIFY=strict`` raises, and the
plan is not cached; the default warns.  Serving runs a stacked bucket
through the same runner in phases (:class:`BatchHandle`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from . import perfmodel as _pm
from .isa import assemble, assemble_pipeline
from .stencil import (Factorization, StencilPipeline, StencilSpec, as_stages,
                      factor_taps)

#: The execution layers a plan can target: ``"ref"`` is the torch oracle
#: chain, ``"cuda"`` the fused hand-written kernels, ``"vm"`` the
#: software SPU (:mod:`repro_torch.core.vm`).
BACKENDS = ("ref", "cuda", "vm")

#: Backends that lower to a fused kernel (resolved tile, ghost strategy).
KERNEL_BACKENDS = ("cuda",)

#: Boundary-ghost strategies a plan can select:
#: ``"pad"`` (oracle: re-extend before every application),
#: ``"pad-free"`` (K1/K3: windows loaded straight from the unpadded grid
#: through the boundary index map), ``"padded-window"`` (K2/K4: windows
#: read from one ``pad_boundary`` copy — grids smaller than one window,
#: and periodic grids past the whole-grid budget), ``"stream"`` (the SPU
#: VM: ghost stream elements served per mode at access time),
#: ``"staged"`` (non-fusable pipelines: the chain runs stage by stage
#: through cached single-sweep stage plans, each choosing its own
#: strategy) and ``"stream-from-host"`` (a block whose device set
#: exceeds the budget, ``perfmodel.slab_budget_bytes``: the grid stays
#: on the host and streams through the device in slabs along dim 0,
#: :mod:`repro_torch.kernels.stream`).
GHOST_STRATEGIES = ("pad", "pad-free", "padded-window", "stream", "staged",
                    "stream-from-host")

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

#: Halo-exchange strategies for one sharded axis of a distributed plan:
#: ``"zero-fill"`` (a rank with no neighbour that far receives zeros),
#: ``"wrap-ring"`` (periodic: every hop is a wrap-around ring) and
#: ``"edge-fixup"`` (the zero-filled exchange, then the out-of-grid
#: ghosts are overwritten locally with the constant fill or the reflect
#: mirror).
EXCHANGE_STRATEGIES = ("zero-fill", "wrap-ring", "edge-fixup")


def exchange_strategy_for(mode: str) -> str:
    """The halo-exchange strategy of one sharded axis under boundary
    ``mode`` (the rule of ``repro.core.plan.exchange_strategy_for``):
    periodic rides a wrap-around ring at the same round count,
    constant/reflect keep the zero-filled exchange and fix the
    out-of-grid ghosts up locally, zero needs nothing more."""
    if mode == "periodic":
        return "wrap-ring"
    if mode in ("constant", "reflect"):
        return "edge-fixup"
    if mode != "zero":
        raise ValueError(f"unknown boundary mode {mode!r}")
    return "zero-fill"


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
    slabs: tuple[tuple[int, int], ...] | None = None
                                        # stream-from-host: (start, stop)
                                        # cover of dim 0
    slab_overlap: int | None = None     # stream-from-host: deep_halo[0]
    slab_budget: int | None = None      # device budget (bytes) the
                                        # in-core decision was held to
                                        # (single-device ref/cuda plans)
    mesh: object = None                 # DeviceMesh of a distributed plan
    grid_axes: tuple | None = None      # mesh dim name per grid dim
    exchange: tuple | None = None       # per-dim exchange strategy / None
    shard_shape: tuple[int, ...] | None = None  # one rank's block
    mesh_fingerprint: tuple | None = None

    @property
    def is_distributed(self) -> bool:
        return self.mesh is not None

    @property
    def stream_plan(self):
        """The assembled stream plan (``program.plan``)."""
        return self.program.plan

    @property
    def streams_from_host(self) -> bool:
        """True when this plan runs out of core, slab by slab."""
        return self.ghost_strategy == "stream-from-host"

    @property
    def needs_host_streaming(self) -> bool:
        """True when the grid must stay on the host: the plan streams, or
        it is a staged chain one of whose stage plans streams."""
        if self.streams_from_host:
            return True
        if not self.fused and self.backend != "vm" and not self.is_distributed:
            return (any(self.stage_plan(k).streams_from_host
                        for k in range(len(self.stages)))
                    or incore_device_bytes(self) > self.slab_budget)
        return False

    @property
    def is_pipeline(self) -> bool:
        return isinstance(self.spec, StencilPipeline)

    @property
    def stages(self) -> tuple[StencilSpec, ...]:
        """The stage chain: the pipeline's stages, or ``(spec,)``."""
        return as_stages(self.spec)

    def stage_plan(self, k: int) -> "ExecutionPlan":
        """The single-sweep plan of stage ``k`` (same shape, dtype,
        backend, tile request, device and mesh), lowered through the
        cache — what the staged fallback executes."""
        return lower(self.stages[k], self.shape, self.dtype,
                     backend=self.backend, sweeps=1, tile=self.tile_request,
                     device=self.device, mesh=self.mesh,
                     grid_axes=self.grid_axes)

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
                     device=self.device, mesh=self.mesh,
                     grid_axes=self.grid_axes)


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


#: Environment switch of the plan verifier (``off`` / ``warn`` /
#: ``strict``).
VERIFY_ENV = "CASPER_VERIFY"


def _verify_new_plan(plan) -> None:
    """Static verification of a freshly lowered plan
    (:func:`repro_torch.analysis.verify_and_record`): strict mode raises
    before the plan enters the cache, the default warns.  Imported here,
    not at the top: the analysis package imports this module."""
    from .. import analysis
    analysis.verify_and_record(plan)


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


def mesh_fingerprint(mesh, grid_axes) -> tuple | None:
    """The identity of a mesh placement: the mesh's dim names, its shape,
    the global ranks in mesh order (two meshes over other ranks, or the
    same ranks in another order, must not share plans: a plan pins its
    mesh) and the grid dim -> mesh dim assignment."""
    if mesh is None:
        return None
    axes = tuple(grid_axes) if grid_axes is not None else None
    if not hasattr(mesh, "mesh_dim_names"):      # a MeshShape: no ranks
        return (tuple(mesh.axis_names), tuple(mesh.shape_tuple), None, axes)
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()), axes)


def mesh_dim_names(mesh) -> tuple:
    """The dim names of a ``DeviceMesh`` or a
    :class:`~repro_torch.sharding.MeshShape`."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_axis_size(mesh, name) -> int:
    """The extent of ``mesh``'s dim ``name`` (1 for ``None``)."""
    if name is None:
        return 1
    if not hasattr(mesh, "mesh_dim_names"):
        return mesh.shape[name]
    return mesh.size(list(mesh.mesh_dim_names).index(name))


def plan_key(spec: StencilSpec, shape, dtype, backend: str, sweeps: int,
             tile, device, mesh=None, grid_axes=None) -> tuple:
    """The plan-cache key: the full spec (boundary + structure ride on
    spec equality), shape, dtype, backend, sweeps, the tile *request*,
    the device, the slab budget and the mesh fingerprint."""
    return (spec, tuple(int(n) for n in shape), dtype_name(dtype),
            backend, int(sweeps), canonical_tile_request(tile),
            canonical_device(device), _pm.slab_budget_bytes(),
            mesh_fingerprint(mesh, grid_axes))


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------
def lower(spec: StencilSpec | StencilPipeline, shape: Sequence[int], dtype,
          *, backend: str = "ref", sweeps: int = 1,
          tile: Sequence[int] | int | None = None,
          device=None, mesh=None, grid_axes=None) -> ExecutionPlan:
    """Lower ``(spec, shape, dtype, …)`` to an :class:`ExecutionPlan`,
    through the process-wide :data:`PLAN_CACHE`.  ``mesh`` (a
    ``DeviceMesh``) and ``grid_axes`` (one mesh dim name or ``None`` per
    grid dim) lower a distributed plan of the global ``shape``; every
    rank of the mesh must lower it (``tile="auto"`` is tuned on mesh rank
    0 and broadcast, so that every rank lowers the same plan)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    shape = tuple(int(n) for n in shape)
    if len(shape) != spec.ndim:
        raise ValueError(f"shape rank {len(shape)} != spec ndim {spec.ndim}")
    if (mesh is None) != (grid_axes is None):
        raise ValueError("mesh and grid_axes must be passed together")
    axes = None
    if mesh is not None:
        axes = tuple(grid_axes)
        if len(axes) != spec.ndim:
            raise ValueError("grid_axes must have one entry per grid dim")
        unknown = [a for a in axes
                   if a is not None and a not in mesh_dim_names(mesh)]
        if unknown:
            raise ValueError(f"grid_axes {unknown} are not dims of the mesh "
                             f"{mesh_dim_names(mesh)}")
        if backend == "vm":
            raise ValueError("a distributed plan runs on backend 'ref' or "
                             "'cuda'")
    tile_req = canonical_tile_request(tile)
    dev = canonical_device(device)
    key = plan_key(spec, shape, dtype, backend, sweeps, tile_req, dev, mesh,
                   axes)
    return PLAN_CACHE.get_or_lower(
        key, lambda: _lower_uncached(spec, shape, canonical_dtype(dtype),
                                     backend, sweeps, tile_req, dev, mesh,
                                     axes))


def _oracle_temps(spec) -> int:
    """Tensors the oracle holds beside an application's input, output and
    padded copy: the tap sum's accumulator and product, and, for a
    factored stage, its term values or a multi-factor term's previous
    pass (``len(terms) + 2``); the largest over the stage chain."""
    return max(2 if (terms := factor_taps(st).compute_terms) is None
               else len(terms) + 2 for st in as_stages(spec))


def _incore_charge(spec, backend: str, ghost: str, deep, sweeps: int,
                   ndim: int):
    """``(pad, extra)`` of an in-core block of a fused ref/cuda plan, for
    ``perfmodel.incore_resident_bytes``: K2/K4 read one ``pad_boundary``
    copy ``deep`` wide and K1/K3 none, each beside its input and output
    only; the oracle pads before each stage application (its widest
    stage) and holds its temporaries (:func:`_oracle_temps`) and, after
    the first application of a block, the block's input."""
    if backend in KERNEL_BACKENDS:
        return (tuple(deep) if ghost == "padded-window" else None), 0
    stages = as_stages(spec)
    pad = tuple(max(st.halo[d] for st in stages) for d in range(ndim))
    return pad, _oracle_temps(spec) + (sweeps * len(stages) > 1)


def _slab_decomposition(shape, deep, itemsize, pad, extra=0,
                        slab_extra=0):
    """The out-of-core decision for a single-device ref/cuda plan:
    ``(budget, slabs, overlap)``.  ``slabs`` is ``None`` while the
    block's device set (``perfmodel.incore_resident_bytes``: input,
    output and, with ``pad`` the ghost widths of the copy the block
    pads, that copy; ``extra`` more tensors) fits the budget; otherwise
    it is an exact cover of dim 0 in equal slabs (a short last slab for
    an extent they do not divide), each sized so the slab executor's
    resident set (``perfmodel.slab_resident_bytes``, with ``slab_extra``
    window-sized temporaries) fits the budget, and ``overlap =
    deep[0]``: a slab's boundary is a ``sweeps*halo`` deep halo against
    host memory."""
    budget = _pm.slab_budget_bytes()
    if _pm.incore_resident_bytes(shape, itemsize, pad, extra) <= budget:
        return budget, None, None
    length = _pm.max_slab_len(shape, deep, itemsize, budget, slab_extra)
    slabs = tuple((s, min(s + length, shape[0]))
                  for s in range(0, shape[0], length))
    return budget, slabs, deep[0]


def _shard_shape(shape, mesh, axes) -> tuple[int, ...]:
    """One rank's block of a ``shape`` grid sharded over ``mesh`` by
    ``axes``; raises where a mesh dim does not divide its grid dim."""
    out = []
    for d, n in enumerate(shape):
        size = mesh_axis_size(mesh, axes[d])
        if n % size:
            raise ValueError(f"grid dim {d} ({n}) not divisible by mesh dim "
                             f"{axes[d]!r} ({size})")
        out.append(n // size)
    return tuple(out)


def _from_mesh_origin(mesh, compute):
    """``compute()`` run on mesh rank 0 (coordinate 0 on every mesh dim)
    and broadcast to every rank of the mesh: one broadcast per mesh dim,
    each from the dim's rank 0, so that after the last every rank holds
    the origin's value."""
    import torch.distributed as dist
    box = [compute() if not any(mesh.get_coordinate()) else None]
    for d in range(mesh.ndim):
        group = mesh.get_group(d)
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                   group=group)
    return box[0]


def _lower_uncached(spec, shape, dtype, backend, sweeps, tile_req,
                    device, mesh=None, axes=None) -> ExecutionPlan:
    """One plan for a spec or a pipeline.  A pipeline's halo is the sum
    of its stage radii and its initial extension is stage 0's; a chain
    that is not fusable lowers ``fused=False`` with strategy
    ``"staged"``, and its stage plans decide everything else.  A ref or
    cuda block past the budget lowers to ``"stream-from-host"`` with its
    slab cover.  A cuda grid whose input and output alone exceed the
    budget streams without a tile for the whole grid; otherwise the
    grid's tile decides the strategy and so whether the padded copy is
    charged, and a plan that then streams takes the tile of a slab.
    Runs only from :meth:`PlanCache.get_or_lower`; every autotune it
    runs is counted in ``autotune_calls``, under the cache lock."""
    halo = spec.halo
    deep = tuple(sweeps * h for h in halo)
    itemsize = torch.empty((), dtype=dtype).element_size()
    pipeline = isinstance(spec, StencilPipeline)
    fused = spec.fusable if pipeline else True

    def resolve_tile(tile_shape):
        if tile_req != "auto":
            return normalize_tile(spec, tile_req, sweeps, itemsize,
                                  tile_shape)
        from ..kernels import tune as _tune
        PLAN_CACHE.autotune_calls += 1
        autotune = _tune.autotune_pipeline if pipeline else _tune.autotune
        return autotune(spec, tile_shape, sweeps=sweeps, itemsize=itemsize,
                        backend=backend).tile

    resolved_tile = None
    slab_budget = slabs = slab_overlap = None
    shard_shape = exchange = None
    ghost = "pad" if fused else "staged"        # oracle default
    if mesh is not None:
        # a rank's block never leaves its device: no slabs, no budget; the
        # shard-local kernel reads the exchanged window (K2/K4)
        shard_shape = _shard_shape(shape, mesh, axes)
        if fused:
            exchange = tuple(None if a is None
                             else exchange_strategy_for(spec.boundary_mode)
                             for a in axes)
        if fused and backend in KERNEL_BACKENDS:
            if tile_req == "auto":
                resolved_tile = tuple(_from_mesh_origin(
                    mesh, lambda: resolve_tile(shard_shape)))
            else:
                resolved_tile = resolve_tile(shard_shape)
            ghost = "padded-window"
            _check_tile_fits(spec, resolved_tile, sweeps, itemsize)
            from ..kernels import engine as _keng
            _keng.check_kernel_args(spec)
    elif not fused:
        if backend != "vm":
            slab_budget = _pm.slab_budget_bytes()
    elif backend == "vm":
        ghost = "stream"
    elif backend in KERNEL_BACKENDS:
        slab_budget, slabs, slab_overlap = _slab_decomposition(
            shape, deep, itemsize, None)
        if slabs is None:
            resolved_tile = resolve_tile(shape)
            ghost = ghost_strategy_for(spec, shape, itemsize, sweeps,
                                       resolved_tile)
            slab_budget, slabs, slab_overlap = _slab_decomposition(
                shape, deep, itemsize, *_incore_charge(
                    spec, backend, ghost, deep, sweeps, len(shape)))
        if slabs is not None:
            # the tile of a slab, not of the grid
            resolved_tile = resolve_tile((slabs[0][1] - slabs[0][0],)
                                         + shape[1:])
            ghost = "stream-from-host"
        _check_tile_fits(spec, resolved_tile, sweeps, itemsize)
        from ..kernels import engine as _keng
        _keng.check_kernel_args(spec)
    else:
        # the oracle's window core holds its temporaries and a restored
        # copy beside the rings
        slab_budget, slabs, slab_overlap = _slab_decomposition(
            shape, deep, itemsize, *_incore_charge(
                spec, backend, ghost, deep, sweeps, len(shape)),
            slab_extra=_oracle_temps(spec) + 1)
        if slabs is not None:
            ghost = "stream-from-host"

    return ExecutionPlan(
        spec=spec, shape=shape, dtype=dtype_name(dtype), backend=backend,
        sweeps=sweeps, device=device, tile=resolved_tile,
        tile_request=tile_req, ghost_strategy=ghost, halo=halo,
        deep_halo=deep,
        factorization=None if pipeline else factor_taps(spec),
        boundary_mode=spec.boundary_mode,
        boundary_value=spec.boundary_value,
        program=assemble_pipeline(spec) if pipeline else assemble(spec),
        fused=fused, slabs=slabs, slab_overlap=slab_overlap,
        slab_budget=slab_budget, mesh=mesh, grid_axes=axes,
        exchange=exchange, shard_shape=shard_shape,
        mesh_fingerprint=mesh_fingerprint(mesh, axes))


# ---------------------------------------------------------------------------
# Execution: thin dispatch to the backend executors
# ---------------------------------------------------------------------------
def incore_device_bytes(plan: ExecutionPlan, batch: int = 1) -> int:
    """Device bytes one in-core block of ``plan`` allocates on ``batch``
    grids at once (``perfmodel.incore_resident_bytes`` with the batch as
    a leading dim: input, output, padded copy and temporaries of the whole
    batch); a staged chain holds its largest stage block's and, past its
    first stage, the block's input."""
    itemsize = torch.empty((), dtype=canonical_dtype(
        plan.dtype)).element_size()
    if not plan.fused:
        return (max(incore_device_bytes(plan.stage_plan(k), batch)
                    for k in range(len(plan.stages)))
                + _pm._allocated(batch * math.prod(plan.shape) * itemsize))
    pad, extra = _incore_charge(plan.spec, plan.backend, plan.ghost_strategy,
                                plan.deep_halo, plan.sweeps, len(plan.shape))
    return _pm.incore_resident_bytes(
        (batch,) + plan.shape, itemsize, None if pad is None else (0,) + pad,
        extra)


def stays_on_host(plan: ExecutionPlan, grid) -> bool:
    """The run-time half of the in-core decision, held to the budget the
    plan was lowered under: ``grid`` stays on the host when the plan
    streams (:attr:`~ExecutionPlan.needs_host_streaming`), or when it
    carries a batch whose in-core blocks together
    (:func:`incore_device_bytes`) exceed the budget though one grid's
    fits; the slab executor then runs the batch a part at a time
    (``repro_torch.kernels.stream.run_plan_streamed``)."""
    if plan.needs_host_streaming:
        return True
    if plan.slab_budget is None or grid.ndim != len(plan.shape) + 1:
        return False
    return incore_device_bytes(plan, grid.shape[0]) > plan.slab_budget


def execute(plan: ExecutionPlan, grid: torch.Tensor) -> torch.Tensor:
    """One fused block — ``plan.sweeps`` applications — on the plan's
    backend (an optional leading batch dim is one more launch axis).  A
    grid that stays on the host (:func:`stays_on_host`) runs the slab
    executor and returns a host tensor.  A non-fusable pipeline plan runs
    its chain through the cached single-sweep stage plans instead:
    chained semantics, per-stage traffic.  A distributed plan maps this
    rank's shard to this rank's shard (:mod:`repro_torch.core.halo`)."""
    if stays_on_host(plan, grid):
        from ..kernels import stream as _stream
        return _stream.run_plan_streamed(plan, grid, plan.sweeps)
    if not plan.fused:
        out = grid
        for _ in range(plan.sweeps):
            for k in range(len(plan.stages)):
                out = execute(plan.stage_plan(k), out)
        return out
    if plan.is_distributed:
        from . import halo as _halo
        return _halo.execute_plan(plan, grid)
    if plan.backend == "ref":
        from . import ref as _ref
        return _ref.execute_plan(plan, grid)
    if plan.backend == "cuda":
        from ..kernels import engine as _keng
        return _keng.execute_plan(plan, grid)
    if plan.backend == "vm":
        from . import vm as _vm
        return _vm.execute_plan(plan, grid)[0]
    raise ValueError(f"unknown backend {plan.backend!r}")


def run_plan(plan: ExecutionPlan, grid: torch.Tensor,
             iters: int) -> torch.Tensor:
    """``iters`` total applications under ``plan``: ``q`` fused blocks in
    a Python loop plus one narrower remainder block whose plan comes from
    the cache.  ``iters == 0`` returns a copy of the input, never the
    input itself (the reference's contract, ``plan.py:773-776``).  A grid
    that stays on the host (:func:`stays_on_host`) runs the slab
    executor's block loop
    (``repro_torch.kernels.stream.run_plan_streamed``), whose result is a
    host tensor."""
    return run_owned(plan, [grid], iters)


def run_owned(plan: ExecutionPlan, held: list, iters: int) -> torch.Tensor:
    """:func:`run_plan` on ``held[0]``, which it takes out of ``held``: a
    grid the caller keeps no other reference to (the runner's copy on the
    device) is freed once the first block has read it, so a run allocates
    no more than one block's device set at a time."""
    q, r = plan.decompose(iters)
    out = held.pop()
    if iters == 0:
        return out.clone()
    if stays_on_host(plan, out):
        from ..kernels import stream as _stream
        return _stream.run_plan_streamed(plan, out, iters)
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


def place(spec, grid, backend: str, sweeps: int, tile_req,
          device) -> tuple[ExecutionPlan, torch.Tensor]:
    """``(plan, grid)`` for a run of this configuration: the plan for
    ``grid``'s shape (one lowering, from the cache after the first) and
    ``grid`` (a numpy array or a tensor, optionally batched) where the
    run takes it: on ``device``, contiguous; or, where the plan decides
    that it stays on the host (:func:`stays_on_host`), where it is — a
    CPU tensor is never copied to the card, and a CUDA tensor is left for
    the slab executor to copy to the host, as the reference copies a
    device array (``np.asarray``)."""
    if isinstance(grid, np.ndarray):
        grid = torch.from_numpy(np.ascontiguousarray(grid))
    plan = lower(spec, _grid_shape_for(spec, grid), grid.dtype,
                 backend=backend, sweeps=sweeps, tile=tile_req,
                 device=device)
    if stays_on_host(plan, grid):
        return plan, grid
    return plan, grid.to(device).contiguous()


@functools.lru_cache(maxsize=512)
def runner(spec, backend: str, sweeps: int, tile_req,
           device: str):
    """Process-wide ``run(grid, iters)`` for an engine configuration: a
    second engine with identical options gets the same callable, and
    every plan it needs comes from :data:`PLAN_CACHE`.  The grid is
    placed first (:func:`place`): on the device, or, where its plan says
    so, left on the host for the slab executor."""
    def run(grid, iters: int) -> torch.Tensor:
        plan, g = place(spec, grid, backend, sweeps, tile_req, device)
        held = [g]
        del g
        return run_owned(plan, held, iters)
    return run


#: Per device, the side streams serving buckets copy on: ``(h2d, d2h)``.
_COPY_STREAMS: dict = {}
_COPY_LOCK = threading.Lock()


def _copy_streams(device: torch.device):
    with _COPY_LOCK:
        key = str(device)
        if key not in _COPY_STREAMS:
            _COPY_STREAMS[key] = (torch.cuda.Stream(device),
                                  torch.cuda.Stream(device))
        return _COPY_STREAMS[key]


@dataclasses.dataclass
class Staged:
    """One bucket after :meth:`BatchHandle.stage`: its plan, its grids
    (``tensor``: on the device, or on the host when the plan keeps them
    there: ``on_host``, :func:`stays_on_host`), the event its upload
    recorded on the copy stream, and the host time staging took
    (``stage_ms``).  :meth:`BatchHandle.dispatch` takes the tensor out
    (``tensor`` is then ``None``)."""

    plan: ExecutionPlan
    tensor: torch.Tensor | None
    event: object = None
    stage_ms: float = 0.0
    on_host: bool = False


@dataclasses.dataclass
class Dispatched:
    """One bucket after :meth:`BatchHandle.dispatch`: its result (on the
    device, or on the host for a bucket run from the host) and the event
    its compute recorded."""

    result: torch.Tensor
    event: object = None


@dataclasses.dataclass(frozen=True)
class BatchHandle:
    """The three phases of one bucket, both servers' execution primitive
    (:mod:`repro_torch.serve`): :func:`runner`'s path on a stacked batch,
    one launch per block for the whole bucket (the reference vmaps its
    single-grid runner).

    ``stage`` stacks the bucket into pinned host memory (the host
    allocator's cached blocks are reused across buckets) and starts its
    upload with a ``non_blocking`` copy on a side stream, recording an
    event; ``dispatch`` makes the caller's current stream wait on that
    event and enqueues the bucket's blocks there (the kernels launch on
    the current stream), recording another; ``fetch`` copies the result
    into pinned host memory on a second side stream that waits on the
    dispatch's event, synchronizes on its own event only and hands out a
    pageable copy (the pinned block goes back to the host allocator's
    cache for the next bucket: pinning a fresh one costs far more than
    the copy).

    ``dispatch`` takes the staged tensor out of its :class:`Staged` (the
    reference's donation): the device copy is freed once the first block
    has read it.  A bucket its plan leaves on the host
    (:func:`stays_on_host`) is not uploaded: ``dispatch`` runs it on the
    slab executor, which returns a host tensor.  On the CPU the phases
    run in turn, without streams."""

    spec: StencilSpec | StencilPipeline
    backend: str
    sweeps: int
    tile_request: object
    device: str

    def stage(self, grids: Sequence) -> Staged:
        """Stack one bucket's grids (numpy arrays or tensors of one shape
        and dtype) on the host and start its upload."""
        t0 = time.perf_counter()
        dev = torch.device(self.device)
        first = grids[0]
        if isinstance(first, np.ndarray):
            dtype = canonical_dtype(first.dtype)
        else:
            dtype = first.dtype
        shape = (len(grids),) + tuple(first.shape)
        plan = lower(self.spec, shape[1:], dtype, backend=self.backend,
                     sweeps=self.sweeps, tile=self.tile_request,
                     device=self.device)
        pinned = dev.type == "cuda"
        host = torch.empty(shape, dtype=dtype, pin_memory=pinned)
        if dtype != torch.bfloat16 and all(isinstance(g, np.ndarray)
                                           for g in grids):
            np.stack(grids, out=host.numpy())
        else:
            torch.stack([torch.as_tensor(g).cpu() for g in grids], out=host)
        on_host = stays_on_host(plan, host)
        if not pinned or on_host:
            return Staged(plan, host, None,
                          (time.perf_counter() - t0) * 1e3, on_host)
        h2d, _ = _copy_streams(dev)
        with torch.cuda.stream(h2d):
            staged = host.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(h2d)
        return Staged(plan, staged, event, (time.perf_counter() - t0) * 1e3)

    def dispatch(self, staged: Staged, iters: int) -> Dispatched:
        """Enqueue the bucket's ``iters`` applications on the current
        stream, after its upload."""
        held = [staged.tensor]
        staged.tensor = None
        if staged.event is None:
            return Dispatched(run_owned(staged.plan, held, iters))
        compute = torch.cuda.current_stream(held[0].device)
        compute.wait_event(staged.event)
        # allocated on the copy stream, read here: the allocator must not
        # hand its memory to the next upload before these blocks ran
        held[0].record_stream(compute)
        out = run_owned(staged.plan, held, iters)
        event = torch.cuda.Event()
        event.record(compute)
        return Dispatched(out, event)

    def fetch(self, dispatched: Dispatched) -> torch.Tensor:
        """The bucket's result as a pageable host tensor, once its
        download has finished."""
        out = dispatched.result
        if dispatched.event is not None and out.device.type == "cuda":
            _, d2h = _copy_streams(out.device)
            d2h.wait_event(dispatched.event)
            with torch.cuda.stream(d2h):
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                out.record_stream(d2h)
                done = torch.cuda.Event()
                done.record(d2h)
            done.synchronize()
            out = host
        return out.clone() if out.is_pinned() else out


def batch_handle(spec: StencilSpec | StencilPipeline, backend: str,
                 sweeps: int, tile_req, device) -> BatchHandle:
    """The :class:`BatchHandle` of one server configuration."""
    return BatchHandle(spec, backend, sweeps,
                       canonical_tile_request(tile_req),
                       canonical_device(device))


def runner_cache_stats() -> dict:
    """Hit/miss counters of the runner cache (a hit: a second engine
    re-used the first's callable), beside the plan cache's
    ``autotune_calls``.  The reference's ``batch_runner`` has no
    counterpart: a bucket runs :func:`runner`'s path through
    :class:`BatchHandle`."""
    return {"runner": runner.cache_info()._asdict(),
            "autotune_calls": PLAN_CACHE.stats()["autotune_calls"]}
