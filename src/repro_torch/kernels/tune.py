"""Tile autotuner of the PyTorch port: ``tile="auto"`` on the card.

The counterpart of ``repro.kernels.tune`` for the hand-written Hopper
kernels K1-K4.  The candidates are :data:`repro_torch.core.plan.HOPPER_TILES`
(the single source; the reference's Volta-shaped ``CANDIDATE_GPU_TILES``
is not carried over), each fitted to a grid smaller than it by the rule
of the default tile (:func:`repro_torch.core.plan.fit_tile`: the chunk cut
to a shallow grid's depth, each dim to the grid, the row rounded to a
16-byte chunk), duplicates dropped, so the candidate that covers a small
grid whole, and with it packing, stays.  :func:`autotune` and
:func:`autotune_pipeline` rank them by the Hopper cost model
(:func:`repro_torch.core.perfmodel.cuda_tile_cost`), memoized on the
spec or pipeline, shape, sweeps, itemsize, backend and the live
calibration fingerprint
(:func:`repro_torch.core.perfmodel.calibration_fingerprint`), so a
``CASPER_CALIBRATION`` change re-ranks.
:func:`repro_torch.core.plan.lower` calls them once per plan for
``tile="auto"``.

:func:`autotune_measured` re-ranks the analytic top candidates by
timing each on the grid's device through the wrapper the plan would
launch (K1/K3 pad-free, or the host pad and K2/K4): between CUDA events
on the card, the first call (the build and warm-up) left out, candidates
interleaved over rounds, the median kept; by wall clock on the CPU,
where the wrappers run their plain versions.  With ``CASPER_TUNE_CACHE``
set to a directory, each measured tune is one JSON file keyed (sha256)
by the spec, shape, dtype width, sweeps, backend, measurement settings,
device kind (the card's name, or ``"cpu"``) and calibration fingerprint;
:data:`TUNE_DISK_CACHE` counts its hits, misses and stores.

:func:`fit_calibration` fits the model's bandwidth and per-CTA cost from
a measured copy bandwidth and measured tiles (the GPU branch of the
reference's ``benchmarks/roofline_stencil.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
import statistics
import time
from typing import Sequence

import torch

from ..core import perfmodel as pm
from ..core import plan as _plan
from ..core.stencil import StencilPipeline, StencilSpec

#: The one backend whose tiles are tuned.
BACKENDS = ("cuda",)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown tuning backend {backend!r}; expected one "
                         f"of {BACKENDS}")


def candidate_tiles(ndim: int, shape: Sequence[int] | None = None,
                    backend: str = "cuda", *, spec=None, sweeps: int = 1,
                    itemsize: int = 4) -> tuple[tuple[int, ...], ...]:
    """The :data:`repro_torch.core.plan.HOPPER_TILES` of rank ``ndim``,
    in their order; with ``shape``, each fitted to a grid smaller than it
    (:func:`repro_torch.core.plan.fit_tile`, for ``spec`` at ``sweeps``
    and ``itemsize``; without ``spec``, no chunk cut), duplicates
    dropped."""
    _check_backend(backend)
    cands = _plan.HOPPER_TILES[ndim]
    if shape is None:
        return cands
    shape = tuple(int(n) for n in shape)
    return tuple(dict.fromkeys(
        _plan.fit_tile(spec, t, sweeps, itemsize, shape) for t in cands))


@dataclasses.dataclass(frozen=True)
class TuneResult:
    tile: tuple[int, ...]
    cost_s: float                       # analytic (or measured) seconds
    table: tuple[tuple[tuple[int, ...], float], ...]   # all (tile, cost)
    measured: bool = False

    def as_dict(self) -> dict:
        return {
            "tile": list(self.tile),
            "cost_s": self.cost_s,
            "measured": self.measured,
            "table": [{"tile": list(t), "cost_s": c} for t, c in self.table],
        }


def autotune(spec: StencilSpec, shape: Sequence[int], sweeps: int = 1,
             itemsize: int = 4, backend: str = "cuda") -> TuneResult:
    """The best candidate tile for ``spec`` on a grid of ``shape`` at
    ``sweeps`` and ``itemsize`` by
    :func:`repro_torch.core.perfmodel.cuda_tile_cost`;
    the table holds every candidate's cost, lowest first.  Raises
    ``ValueError`` when no candidate fits one block's shared memory."""
    return _autotune(spec, tuple(int(n) for n in shape), int(sweeps),
                     int(itemsize), backend, pm.calibration_fingerprint())


def autotune_pipeline(pipeline: StencilPipeline, shape: Sequence[int],
                      sweeps: int = 1, itemsize: int = 4,
                      backend: str = "cuda") -> TuneResult:
    """:func:`autotune` of a fused stage chain (K3/K4), ranked by
    :func:`repro_torch.core.perfmodel.cuda_pipeline_tile_cost`."""
    return _autotune(pipeline, tuple(int(n) for n in shape), int(sweeps),
                     int(itemsize), backend, pm.calibration_fingerprint())


@functools.lru_cache(maxsize=512)
def _autotune(spec, shape, sweeps, itemsize, backend, _cal) -> TuneResult:
    _check_backend(backend)
    cost = (pm.cuda_pipeline_tile_cost if isinstance(spec, StencilPipeline)
            else pm.cuda_tile_cost)
    scored = sorted(
        ((tile, cost(spec, shape, tile, sweeps, itemsize))
         for tile in candidate_tiles(spec.ndim, shape, backend, spec=spec,
                                     sweeps=sweeps, itemsize=itemsize)),
        key=lambda tc: tc[1])
    best, c = scored[0]
    if math.isinf(c):
        raise ValueError(f"no candidate tile fits H100 shared memory for "
                         f"{spec.name} sweeps={sweeps}")
    return TuneResult(best, c, tuple(scored))


# ---------------------------------------------------------------------------
# Measured re-ranking and the persistent cache
# ---------------------------------------------------------------------------
#: Directory of persisted :func:`autotune_measured` results; unset (the
#: default), measured tunes stay in the process.
TUNE_CACHE_ENV = "CASPER_TUNE_CACHE"


@dataclasses.dataclass
class TuneDiskCacheStats:
    """Counters of the ``CASPER_TUNE_CACHE`` store: ``hits`` served from
    disk, ``misses`` that measured, ``stores`` written."""
    hits: int = 0
    misses: int = 0
    stores: int = 0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "stores": self.stores}

    def reset(self) -> None:
        self.hits = self.misses = self.stores = 0


TUNE_DISK_CACHE = TuneDiskCacheStats()


def device_kind(device) -> str:
    """What a measured tune was taken on: the card's name for a CUDA
    device, ``"cpu"`` otherwise — part of the disk-cache key, so a tune
    measured on the host is never served on the card."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _tune_cache_dir() -> str | None:
    return os.environ.get(TUNE_CACHE_ENV, "").strip() or None


def _tune_cache_key(spec, shape, itemsize, sweeps, backend, top_k, reps,
                    kind: str) -> str:
    """The full spec or pipeline (taps, boundary, structure), the grid's
    shape (batch included), dtype width, sweeps, backend, the measurement
    settings, the device kind and the calibration fingerprint."""
    payload = repr((spec, tuple(int(n) for n in shape), int(itemsize),
                    int(sweeps), backend, int(top_k), int(reps), kind,
                    pm.calibration_fingerprint()))
    return hashlib.sha256(payload.encode()).hexdigest()[:40]


def _tune_cache_load(key: str) -> TuneResult | None:
    root = _tune_cache_dir()
    if root is None:
        return None
    try:
        with open(os.path.join(root, key + ".json"), encoding="utf-8") as fh:
            payload = json.load(fh)
        table = tuple((tuple(row["tile"]), float(row["cost_s"]))
                      for row in payload["table"])
        return TuneResult(tuple(payload["tile"]), float(payload["cost_s"]),
                          table, measured=True)
    except (OSError, ValueError, KeyError, TypeError):
        return None          # absent or corrupt: measure again


def _tune_cache_store(key: str, result: TuneResult) -> None:
    root = _tune_cache_dir()
    if root is None:
        return
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, key + ".json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(result.as_dict(), fh)
    os.replace(tmp, path)    # atomic: a reader never sees a partial file
    TUNE_DISK_CACHE.stores += 1


def measure_tiles(spec, grid: torch.Tensor, tiles, sweeps: int = 1,
                  rounds: int = 2, strategy: str | None = None
                  ) -> tuple[tuple[tuple[int, ...], float], ...]:
    """Seconds of one fused block of ``spec`` (a spec or a fusable
    pipeline) on ``grid`` at each of ``tiles``: the median of ``rounds``
    calls, the tiles taken in turn within each round, through the wrapper
    the plan would launch (``strategy=None``: the ghost strategy
    :func:`repro_torch.core.plan.ghost_strategy_for` picks for the tile).
    One call of each tile first is left out (on the card: the kernels'
    build and warm-up), and every timed call follows an untimed call of
    the same tile: on an H100 a block timed right after a much longer one
    ran up to 30% slower (``tools/tile_probe.py``).  On a CUDA tensor each
    call is timed between CUDA events on the current stream; on the CPU
    by wall clock."""
    from . import engine as _keng
    apply = (_keng.pipeline_apply if isinstance(spec, StencilPipeline)
             else _keng.stencil_apply)
    tiles = [tuple(int(t) for t in tile) for tile in tiles]
    cuda = grid.device.type == "cuda"

    def block(tile):
        return apply(spec, grid, tile=tile, sweeps=sweeps, strategy=strategy)

    for tile in tiles:
        block(tile)
    if cuda:
        torch.cuda.synchronize(grid.device)
    times = {tile: [] for tile in tiles}
    for _ in range(rounds):
        for tile in tiles:
            block(tile)
            if cuda:
                torch.cuda.synchronize(grid.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                block(tile)
                end.record()
                end.synchronize()
                times[tile].append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                block(tile)
                times[tile].append(time.perf_counter() - t0)
    return tuple((tile, statistics.median(times[tile])) for tile in tiles)


def autotune_measured(spec, grid: torch.Tensor, sweeps: int = 1,
                      top_k: int = 3, reps: int = 2,
                      backend: str = "cuda") -> TuneResult:
    """Re-rank the ``top_k`` analytic candidates for ``grid`` (a spec or
    a fusable pipeline; an optional leading batch dim) by
    :func:`measure_tiles` over ``reps`` rounds on the grid's own device.
    With ``CASPER_TUNE_CACHE`` set, results persist across processes."""
    _check_backend(backend)
    itemsize = grid.element_size()
    key = _tune_cache_key(spec, grid.shape, itemsize, sweeps, backend, top_k,
                          reps, device_kind(grid.device))
    if _tune_cache_dir() is not None:
        cached = _tune_cache_load(key)
        if cached is not None:
            TUNE_DISK_CACHE.hits += 1
            return cached
        TUNE_DISK_CACHE.misses += 1
    tune = (autotune_pipeline if isinstance(spec, StencilPipeline)
            else autotune)
    analytic = tune(spec, tuple(grid.shape[grid.ndim - spec.ndim:]),
                    sweeps=sweeps, itemsize=itemsize, backend=backend)
    finite = [t for t, c in analytic.table if math.isfinite(c)][:top_k]
    timed = sorted(measure_tiles(spec, grid, finite, sweeps, reps),
                   key=lambda tc: tc[1])
    result = TuneResult(timed[0][0], timed[0][1], tuple(timed),
                        measured=True)
    _tune_cache_store(key, result)
    return result


def fit_calibration(measured_bw: float, timed: Sequence[dict]) -> dict:
    """The model's constants fitted from measurement: ``gpu_bw`` is the
    measured copy bandwidth, and ``gpu_cta_step_s`` the slope of the
    block time between the two measured tiles of the fewest and the most
    CTAs (``timed``: dicts of ``"n_ctas"`` and ``"seconds"``), clamped to
    ``>= 0`` (noise can invert it).  The reference also sets
    ``gpu_n_sms = 0.5`` on a positive slope, because its CPU interpreter
    runs CTAs one after another; the card runs them on 132 SMs at once,
    so that rule has no place here and the SM count stands."""
    xs = sorted(timed, key=lambda r: r["n_ctas"])
    lo, hi = xs[0], xs[-1]
    step = 0.0
    if hi["n_ctas"] > lo["n_ctas"]:
        step = max(0.0, (hi["seconds"] - lo["seconds"])
                   / (hi["n_ctas"] - lo["n_ctas"]))
    return {"gpu_bw": float(measured_bw), "gpu_cta_step_s": step}
