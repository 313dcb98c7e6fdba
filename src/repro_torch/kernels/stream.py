"""Out-of-core slab streaming: the ``"stream-from-host"`` plan executor.

The port's counterpart of ``repro.kernels.stream``.  A grid whose block
would not fit the device budget (``perfmodel.slab_budget_bytes``, env
``CASPER_SLAB_BUDGET``; the block's input, output and padded copy count,
``perfmodel.incore_resident_bytes``) stays on the host and streams
through the device in slabs along dim 0.  A slab's boundary is a halo
against host memory: its window carries ``sweeps*halo`` ghost rows per
side taken from the neighbouring host rows, so K2/K4 (or, for
``backend="ref"``, the oracle's window core) compute every slab
unchanged, with the slab's global origin, and the result is f64
bit-identical to the whole-grid block.  The overlap rows are recomputed
by both neighbouring slabs, so every block is a complete pass over the
grid and ``iters = q*sweeps + r`` composes as in core.

On the card the host link is the bound, so the host moves no element by
itself:

* **Uploads are DMAs.**  A slab's rows go from pinned host memory into
  the interior of a padded window on the device, one pitched copy
  (``casper_copy_box`` in ``csrc/stencil.cu``: ``cudaMemcpy2DAsync`` /
  ``cudaMemcpy3DAsync``) per contiguous run of the dim-0 row map
  (:func:`row_map`: periodic wraps, reflect folds, rows outside the grid,
  an overlap deeper than a slab).  Rows outside a zero/constant grid and
  the ghosts of dims 1.. are filled on the device: zero/constant ghosts
  once per run (the copies never write them), periodic/reflect ghosts by
  device copies from the window's own interior after each upload.
* **Three streams ordered by events.**  Slab ``k+1`` uploads on an H2D
  stream while K2/K4 computes slab ``k`` on the caller's stream and slab
  ``k-1`` downloads on a D2H stream into pinned host memory; no
  ``synchronize`` sits inside the slab loop.
* **Buffers.**  Per run, two pinned host grids used in turn by the
  blocks, so the caller's tensor is never written: a pinned input is
  read in place, any other input (a pageable CPU tensor, a CUDA tensor)
  is copied once into pinned memory (timed in :data:`LAST_RUN`).  A
  pinned allocation that fails raises; there is no pageable path.  The
  device buffers, a ring of two windows and a ring of two output slabs,
  are allocated once per plan of the run
  (``perfmodel.slab_resident_bytes`` counts them, and, for
  ``backend="ref"``, the oracle window core's temporaries).

A batch whose in-core blocks fit the budget one grid at a time but not
together (``plan.stays_on_host``) stays on the host too and runs in core
as many grids at a time as fit.

On a CPU device the same executor runs without streams, on K2/K4's plain
versions: that is what the tests drive.  The result of a streamed run is
a CPU tensor (pinned on a CUDA device).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core import plan as _plan
from ..core import ref as _ref
from . import engine as _keng

#: Bytes the executor copied between host and device since
#: :func:`reset_traffic`, by direction (on a CPU device, the bytes the
#: same copies move within the host).
TRAFFIC = {"h2d": 0, "d2h": 0}

#: The last run's host side: ``pin_ms`` (pinned allocations),
#: ``stage_ms`` (the input's one copy into pinned memory; 0 for a pinned
#: input), ``pinned_bytes`` (host bytes allocated for the run) and
#: ``issue_ms`` (the host's time to enqueue every slab of every streamed
#: block, before it waits for the last download).
LAST_RUN = {"pin_ms": 0.0, "stage_ms": 0.0, "pinned_bytes": 0,
            "issue_ms": 0.0}


def reset_traffic() -> None:
    TRAFFIC["h2d"] = TRAFFIC["d2h"] = 0


def row_map(start: int, stop: int, overlap: int, n0: int,
            mode: str) -> np.ndarray:
    """The host row each window row of slab ``[start, stop)`` reads, by
    global coordinate ``start - overlap ... stop + overlap - 1``:
    periodic wraps, reflect folds, and a row outside a zero/constant grid
    maps to ``-1`` (filled on the device).  An overlap deeper than a slab
    simply reaches across several host slabs."""
    idx = np.arange(start - overlap, stop + overlap)
    if mode == "periodic":
        return _ref.periodic_index(idx, n0)
    if mode == "reflect":
        return _ref.reflect_index(idx, n0)
    return np.where((idx >= 0) & (idx < n0), idx, -1)


def _runs(rows: np.ndarray) -> list[tuple[int, int, int]]:
    """``(window row, host row or -1, length)`` per maximal run of
    consecutive host rows (or of fill rows) in a row map."""
    fill = rows < 0
    same = (fill[1:] & fill[:-1]) | (~fill[1:] & ~fill[:-1]
                                     & (np.diff(rows) == 1))
    starts = np.concatenate(([0], np.flatnonzero(~same) + 1))
    stops = np.concatenate((starts[1:], [len(rows)]))
    return [(int(a), max(int(rows[a]), -1), int(b - a))
            for a, b in zip(starts, stops)]


def _fill_value(plan) -> float:
    return plan.boundary_value if plan.boundary_mode == "constant" else 0.0


def _interior(window: torch.Tensor, plan) -> torch.Tensor:
    """The view of ``window`` that holds grid values in dims 1..."""
    idx = (slice(None),) + tuple(slice(d, d + n) for d, n in
                                 zip(plan.deep_halo[1:], plan.shape[1:]))
    return window[idx]


def _copy_rows(dst: torch.Tensor, src: torch.Tensor, stream) -> None:
    """Copy host rows ``src`` (contiguous) into ``dst``, a window's
    interior view: on a CUDA ``dst``, one DMA on ``stream``."""
    if dst.device.type == "cpu":
        dst.copy_(src)
        return
    isz = src.element_size()
    rows = src.shape[0]
    if src.ndim == 1:
        box = (rows * isz, 1, 1, 0, 1, 0, 1)
    elif src.ndim == 2:
        box = (src.shape[1] * isz, 1, rows, dst.stride(0) * isz, 1,
               src.shape[1] * isz, 1)
    else:
        box = (src.shape[2] * isz, src.shape[1], rows, dst.stride(1) * isz,
               dst.stride(0) // dst.stride(1), src.shape[2] * isz,
               src.shape[1])
    lib = _keng._lib()
    err = lib.casper_copy_box(dst.device.index, dst.data_ptr(),
                              src.data_ptr(), *box, 1, stream.cuda_stream)
    if err:
        raise RuntimeError(f"slab upload failed: "
                           f"{lib.casper_error_string(err).decode()}")


def _fill_ghosts(window: torch.Tensor, plan) -> None:
    """Periodic/reflect ghosts of dims 1.. from the window's own interior
    (dim 1 first, then dim 2 over the whole of dim 1, as ``pad_boundary``
    composes them); one device copy per run of consecutive sources."""
    fold = (_ref.periodic_index if plan.boundary_mode == "periodic"
            else _ref.reflect_index)
    for d in range(1, len(plan.shape)):
        w, n = plan.deep_halo[d], plan.shape[d]
        pos = list(range(w)) + list(range(w + n, 2 * w + n))
        src = [w + fold(p - w, n) for p in pos]
        i = 0
        while i < len(pos):
            j = i + 1
            while (j < len(pos) and pos[j] == pos[j - 1] + 1
                   and src[j] == src[j - 1] + 1):
                j += 1
            window.narrow(d, pos[i], j - i).copy_(
                window.narrow(d, src[i], j - i))
            i = j


def _upload(plan, host: torch.Tensor, window: torch.Tensor, start: int,
            stop: int, stream=None) -> None:
    """Fill ``window`` (``stop - start + 2*overlap`` rows) with slab
    ``[start, stop)``'s input: DMAs of the mapped host rows into its
    interior, fill rows, then the dims-1.. ghosts of periodic/reflect
    (zero/constant ghosts were filled when the window was made)."""
    interior = _interior(window, plan)
    row_bytes = host[0].numel() * host.element_size()
    rows = row_map(start, stop, plan.slab_overlap, plan.shape[0],
                   plan.boundary_mode)
    for at, src, length in _runs(rows):
        if src < 0:
            window[at:at + length].fill_(_fill_value(plan))
        else:
            _copy_rows(interior[at:at + length], host[src:src + length],
                       stream)
            TRAFFIC["h2d"] += length * row_bytes
    if plan.boundary_mode in ("periodic", "reflect"):
        _fill_ghosts(window, plan)


def _empty_window(plan, rows: int, device) -> torch.Tensor:
    shape = (rows,) + tuple(n + 2 * d for n, d in zip(plan.shape[1:],
                                                      plan.deep_halo[1:]))
    return torch.full(shape, _fill_value(plan),
                      dtype=_plan.canonical_dtype(plan.dtype), device=device)


def slab_window(host: torch.Tensor, slab: tuple[int, int], overlap: int,
                plan) -> torch.Tensor:
    """One slab's input window from the host-resident grid, on the host:
    dim-0 rows ``[start - overlap, stop + overlap)`` by global coordinate
    through :func:`row_map`, dims 1.. ghost-padded ``deep_halo[d]`` wide
    by the plan's boundary mode — what K2/K4 read (the executor builds the
    same window on the device, :func:`_upload`)."""
    start, stop = slab
    if overlap != plan.slab_overlap:
        raise ValueError(f"overlap {overlap} != the plan's "
                         f"{plan.slab_overlap}")
    window = _empty_window(plan, stop - start + 2 * overlap, host.device)
    _upload(plan, host, window, start, stop)
    return window


def _compute(plan, window: torch.Tensor, out: torch.Tensor,
             start: int) -> None:
    """One slab's fused block into ``out``: K2/K4 with the slab's global
    origin (their plain versions on the host), or the oracle's window
    core for ``backend="ref"``."""
    spec = plan.spec
    starts = (start,) + (0,) * (len(plan.shape) - 1)
    out_shape = tuple(out.shape)
    if plan.backend == "cuda":
        fn = (_keng.pipeline_window_sweep if plan.is_pipeline
              else _keng.stencil_window_sweep)
        fn(spec, window, out_shape, starts, plan.shape, tile=plan.tile,
           sweeps=plan.sweeps, out=out)
    elif plan.is_pipeline:
        out.copy_(_ref.masked_window_pipeline(
            window, spec.stages, out_shape, plan.sweeps, starts, plan.shape,
            window.dtype))
    else:
        out.copy_(_ref.masked_window_sweeps(
            window, spec.taps, plan.halo, out_shape, plan.sweeps, starts,
            plan.shape, window.dtype, mode=plan.boundary_mode,
            value=plan.boundary_value, structure=spec.structure))


class _Ring:
    """The device buffers of one streamed plan: two windows and two
    output slabs (one tensor each, ``perfmodel.slab_resident_bytes``),
    and on a CUDA device the H2D and D2H streams."""

    def __init__(self, plan):
        device = torch.device(plan.device)
        longest = max(stop - start for start, stop in plan.slabs)
        dtype = _plan.canonical_dtype(plan.dtype)
        inner = tuple(n + 2 * d for n, d in zip(plan.shape[1:],
                                                plan.deep_halo[1:]))
        self.win = torch.empty((2, longest + 2 * plan.slab_overlap) + inner,
                               dtype=dtype, device=device)
        if plan.boundary_mode in ("zero", "constant"):
            self.win.fill_(_fill_value(plan))
        self.out = torch.empty((2, longest) + tuple(plan.shape[1:]),
                               dtype=dtype, device=device)
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(device=device)
            self.d2h = torch.cuda.Stream(device=device)


def _run_block(plan, ring: _Ring, src: torch.Tensor,
               dst: torch.Tensor) -> None:
    """One fused block over every slab, ``src`` to ``dst`` (host grids):
    slab ``k+1`` uploads while slab ``k`` computes and slab ``k-1``
    downloads, each on its own stream, ordered by events (a window slot
    is reused once its kernel is done, an output slot once its download
    is)."""
    ov = plan.slab_overlap
    if not ring.cuda:
        for k, (start, stop) in enumerate(plan.slabs):
            w = ring.win[k % 2, :stop - start + 2 * ov]
            o = ring.out[k % 2, :stop - start]
            _upload(plan, src, w, start, stop)
            _compute(plan, w, o, start)
            dst[start:stop].copy_(o)
            TRAFFIC["d2h"] += o.numel() * o.element_size()
        return
    t0 = time.perf_counter()
    compute = torch.cuda.current_stream(ring.win.device)
    ring.h2d.wait_stream(compute)          # the rings' fill, earlier work
    ring.d2h.wait_stream(compute)
    win_free = [None, None]
    out_free = [None, None]
    for k, (start, stop) in enumerate(plan.slabs):
        s = k % 2
        w = ring.win[s, :stop - start + 2 * ov]
        o = ring.out[s, :stop - start]
        with torch.cuda.stream(ring.h2d):
            if win_free[s] is not None:
                ring.h2d.wait_event(win_free[s])
            _upload(plan, src, w, start, stop, ring.h2d)
            ready = torch.cuda.Event()
            ready.record(ring.h2d)
        compute.wait_event(ready)
        if out_free[s] is not None:
            compute.wait_event(out_free[s])
        _compute(plan, w, o, start)
        done = torch.cuda.Event()
        done.record(compute)
        win_free[s] = done
        with torch.cuda.stream(ring.d2h):
            ring.d2h.wait_event(done)
            dst[start:stop].copy_(o, non_blocking=True)
            freed = torch.cuda.Event()
            freed.record(ring.d2h)
        out_free[s] = freed
        TRAFFIC["d2h"] += o.numel() * o.element_size()
    compute.wait_stream(ring.d2h)
    LAST_RUN["issue_ms"] += (time.perf_counter() - t0) * 1e3
    ring.d2h.synchronize()


def _run_in_core(plan, src: torch.Tensor, dst: torch.Tensor) -> None:
    """A block of a host-streamed run whose own plan fits the budget (a
    remainder, or a stage of a staged chain): the grid to the device, the
    block, the result back."""
    g = src.to(plan.device, non_blocking=True)
    dst.copy_(_plan.execute(plan, g))
    TRAFFIC["h2d"] += src.numel() * src.element_size()
    TRAFFIC["d2h"] += src.numel() * src.element_size()


def _host_empty(shape, dtype, pinned: bool) -> torch.Tensor:
    t0 = time.perf_counter()
    out = torch.empty(shape, dtype=dtype, pin_memory=pinned)
    LAST_RUN["pin_ms"] += (time.perf_counter() - t0) * 1e3
    LAST_RUN["pinned_bytes"] += out.numel() * out.element_size()
    return out


def _run_sequence(blocks, grid: torch.Tensor) -> torch.Tensor:
    """Run ``blocks`` (one plan per fused block, in order) on ``grid``,
    ping-ponging between two host grids."""
    pinned = torch.device(blocks[0].device).type == "cuda"
    LAST_RUN.update(pin_ms=0.0, stage_ms=0.0, pinned_bytes=0, issue_ms=0.0)
    if grid.device.type == "cpu" and grid.is_contiguous() and (
            not pinned or grid.is_pinned()):
        src, pool = grid, []                    # read in place
    else:
        src = _host_empty(grid.shape, grid.dtype, pinned)
        t0 = time.perf_counter()
        src.copy_(grid)
        LAST_RUN["stage_ms"] = (time.perf_counter() - t0) * 1e3
        pool = [src]
    i = 0
    while i < len(blocks):
        plan = blocks[i]
        ring = _Ring(plan) if plan.streams_from_host else None
        while i < len(blocks) and blocks[i] is plan:
            dst = next((b for b in pool if b is not src), None)
            if dst is None:
                dst = _host_empty(grid.shape, grid.dtype, pinned)
                pool.append(dst)
            if ring is None:
                _run_in_core(plan, src, dst)
            else:
                _run_block(plan, ring, src, dst)
            src = dst
            i += 1
        del ring
    return src


def _block_plans(plan, iters: int) -> list:
    """The plan of each fused block of ``iters`` applications: ``q``
    blocks of ``plan`` and one remainder block, or, for a staged chain,
    every stage plan of every chain application."""
    if not plan.fused:
        stages = [plan.stage_plan(k) for k in range(len(plan.stages))]
        return stages * iters
    q, r = plan.decompose(iters)
    return [plan] * q + ([plan.remainder(r)] if r else [])


def execute_plan(plan, grid: torch.Tensor) -> torch.Tensor:
    """One fused block of a ``"stream-from-host"`` plan: the host-side
    twin of ``kernels.engine.execute_plan``, returning the updated grid as
    a host tensor (an optional leading batch dim runs grid by grid)."""
    if not plan.streams_from_host:
        raise ValueError(
            f"not a slab-streamed plan: ghost={plan.ghost_strategy!r}")
    if grid.ndim == len(plan.shape) + 1:
        return torch.stack([execute_plan(plan, g) for g in grid])
    if tuple(grid.shape) != plan.shape:
        raise ValueError(f"grid shape {tuple(grid.shape)} != plan shape "
                         f"{plan.shape}")
    return _run_sequence([plan], grid)


def part_size(plan, batch: int, iters: int) -> int:
    """Grids of a batch that :func:`run_plan_streamed` runs in core at a
    time when the batch stays on the host though one grid fits: the most
    whose blocks (``plan.incore_device_bytes``, the remainder's too) fit
    the budget together."""
    q, r = plan.decompose(iters)
    blocks = [plan] + ([plan.remainder(r)] if plan.fused and r else [])

    def fits(m):
        return all(_plan.incore_device_bytes(p, m) <= plan.slab_budget
                   for p in blocks)
    lo, hi = 1, batch
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def _run_batch_in_parts(plan, grid: torch.Tensor,
                        iters: int) -> torch.Tensor:
    """A batch whose in-core blocks fit the budget one grid at a time but
    not together: :func:`part_size` grids at a time, each part copied to
    the device, run in core and copied back into one host batch (pinned
    on a CUDA device)."""
    lo = part_size(plan, grid.shape[0], iters)
    LAST_RUN.update(pin_ms=0.0, stage_ms=0.0, pinned_bytes=0, issue_ms=0.0)
    out = _host_empty(grid.shape, grid.dtype,
                      torch.device(plan.device).type == "cuda")
    for a in range(0, grid.shape[0], lo):
        part = grid[a:a + lo]
        # the device copy is the run's own: freed after its first block
        out[a:a + lo].copy_(_plan.run_owned(plan, [part.to(plan.device)],
                                            iters))
        TRAFFIC["h2d"] += part.numel() * part.element_size()
        TRAFFIC["d2h"] += part.numel() * part.element_size()
    return out


def run_plan_streamed(plan, grid: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` total applications on the host-streaming path: ``q``
    slab passes plus one remainder pass whose plan comes from the cache
    (a remainder that fits the budget runs in core); a staged chain whose
    stage plans stream (``plan.needs_host_streaming``) runs stage by
    stage.  A batch of streamed grids runs grid by grid; a batch of grids
    that fit the budget one at a time but not together runs in core a
    part at a time.  ``iters=0`` returns a host copy that never aliases
    the input."""
    plan.decompose(iters)
    if iters == 0:
        return grid.to("cpu", copy=True)
    if grid.ndim == len(plan.shape) + 1:
        if not plan.needs_host_streaming:
            return _run_batch_in_parts(plan, grid, iters)
        return torch.stack([run_plan_streamed(plan, g, iters) for g in grid])
    return _run_sequence(_block_plans(plan, iters), grid)


def _block_traffic(plan) -> tuple[int, int]:
    """(H2D, D2H) bytes of one block of ``plan`` on the host-streaming
    path: the mapped rows of every slab window, unpadded, and the grid;
    or, in core, the grid each way."""
    itemsize = torch.empty((), dtype=_plan.canonical_dtype(
        plan.dtype)).element_size()
    grid_bytes = math.prod(plan.shape) * itemsize
    if not plan.streams_from_host:
        return grid_bytes, grid_bytes
    row_bytes = grid_bytes // plan.shape[0]
    rows = sum(int((row_map(a, b, plan.slab_overlap, plan.shape[0],
                            plan.boundary_mode) >= 0).sum())
               for a, b in plan.slabs)
    return rows * row_bytes, grid_bytes


def host_device_traffic(plan, iters: int | None = None) -> dict:
    """Host<->device bytes of a streamed run against the whole-grid
    baseline (one upload and one download of the grid for the whole run).
    Per block the executor uploads the grid rows each slab window maps
    (dims 1.. unpadded: their ghosts and the rows outside a zero/constant
    grid are filled on the device, where the reference's model counts
    padded windows) and downloads the grid; a remainder block is counted
    on its own plan.  ``iters=None``: one fused block."""
    blocks = [plan] if iters is None else _block_plans(plan, iters)
    h2d = d2h = 0
    for p in blocks:
        up, down = _block_traffic(p)
        h2d += up
        d2h += down
    grid_bytes = math.prod(plan.shape) * torch.empty(
        (), dtype=_plan.canonical_dtype(plan.dtype)).element_size()
    return {
        "n_slabs": len(plan.slabs or ()),
        "slab_overlap": plan.slab_overlap,
        "blocks": len(blocks),
        "slab_h2d_bytes": h2d,
        "slab_d2h_bytes": d2h,
        "whole_h2d_bytes": grid_bytes,
        "whole_d2h_bytes": grid_bytes,
        "overhead": (h2d + d2h) / (2 * grid_bytes),
    }
