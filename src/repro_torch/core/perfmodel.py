"""The Hopper constants that lowering reads, the tile cost model, the
slab-streaming budget, and the paper's analytic model.

Three parts, each on its own machine:

* **The H100 this port runs on** (every ``H100_*`` name): the budgets
  :func:`repro_torch.core.plan.lower` and the kernel wrappers' launch
  geometry consult, the measured calibration (``CASPER_CALIBRATION``,
  the reference's ``perfmodel.py:253-334``) and the Hopper tile cost of
  the kernels K1-K4 as ``csrc/stencil.cu`` builds them
  (:func:`cuda_tile_cost`, :func:`cuda_pipeline_tile_cost`), which ranks
  tiles for ``tile="auto"`` (:mod:`repro_torch.kernels.tune`).
* **The device budget** (``CASPER_SLAB_BUDGET``): the in-core rule
  (:func:`incore_resident_bytes`) and the slab executor's resident set
  (:func:`slab_resident_bytes`, :func:`max_slab_len`), the reference's
  ``perfmodel.py:358-393`` counted for the port's executor
  (:mod:`repro_torch.kernels.stream`).
* **The paper's modeled machines** (Table 2's CPU with Casper's SPUs in
  its LLC, the Titan V GPU of §7.1 and the HMC PIMS of §8.4): the
  first-order model behind Figures 10-13 and Tables 5-6
  (:func:`cpu_sweep`, :func:`casper_sweep`, :func:`gpu_sweep`,
  :func:`pims_sweep`, :func:`speedup_table`, :func:`energy_table`),
  copied from ``repro.core.perfmodel`` (``:28-207``, ``:750-847``) float
  for float.  Its constants describe those machines, never the H100.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

from .isa import Program, assemble
from .segment import SegmentConfig, remote_fraction
from .stencil import DOMAIN_SIZES, PAPER_STENCILS, StencilSpec

#: H100 SXM device memory, 80 GB (NVIDIA H100 data sheet): the default
#: device budget.  A block whose device set (:func:`incore_resident_bytes`)
#: exceeds it, or ``CASPER_SLAB_BUDGET``, streams from the host in slabs.
H100_HBM_BYTES = 80 * 10 ** 9

#: H100 SXM HBM3 bandwidth, 3.35 TB/s (NVIDIA H100 data sheet).
H100_HBM_BW = 3.35e12

#: H100 L2 cache, 50 MB (NVIDIA Hopper architecture white paper).
H100_L2_BYTES = 50 * 10 ** 6

#: Largest dynamic shared memory one block may opt into on Hopper:
#: 227 KB = 232,448 bytes (CUDA C++ programming guide, compute
#: capability 9.0).  The fused kernels' two window buffers must fit it.
H100_SMEM_PER_BLOCK = 232448

#: H100 SXM streaming multiprocessors (NVIDIA H100 data sheet).
H100_SMS = 132

#: Shared memory of one H100 SM that blocks can share: 228 KB = 233,472
#: bytes, of which the system reserves 1 KB per resident block (CUDA C++
#: programming guide, compute capability 9.0).
H100_SMEM_PER_SM = 233472
H100_SMEM_RESERVED_PER_BLOCK = 1024

#: Whole-grid budget of the periodic pad-free decision: periodic grids
#: above it take the padded-window kernel (K2) and its host pad.  The
#: reference sized it as a quarter of the fast memory the grid must sit
#: in (``perfmodel.py:248``: L2 // 4 on the GPU path), because a Pallas
#: block held the whole grid.  K1 reads periodic ghosts from device
#: memory through the boundary index map, so no such limit binds it, and
#: on the H100 K1 beat K2 plus the pad at every periodic size measured
#: (``tools/rank3_probe.py``; PERF.md): the budget is the whole device
#: memory, above which the plan streams from the host anyway.
PERIODIC_WHOLE_GRID_BYTES = H100_HBM_BYTES

#: Environment override for the slab budget (bytes); part of the plan
#: cache key, as in the reference.
SLAB_BUDGET_ENV = "CASPER_SLAB_BUDGET"


def slab_budget_bytes() -> int:
    """The device-memory budget for whole-grid residency:
    :data:`H100_HBM_BYTES` unless ``CASPER_SLAB_BUDGET`` overrides it."""
    raw = os.environ.get(SLAB_BUDGET_ENV)
    if raw is None:
        return H100_HBM_BYTES
    budget = int(raw)
    if budget < 1:
        raise ValueError(f"{SLAB_BUDGET_ENV} must be >= 1 byte, got {raw!r}")
    return budget


#: The CUDA caching allocator's accounting (what
#: ``torch.cuda.memory_allocated`` counts): every block is a whole number
#: of 512-byte granules, and a block of more than 1 MiB is cut from a
#: larger cached one only when more than 1 MiB would remain, so it may
#: carry up to 1 MiB more than asked for.
ALLOC_GRANULE = 512
ALLOC_SPLIT = 2 ** 20


def _allocated(n_bytes: int) -> int:
    """The most the allocator counts for a request of ``n_bytes``."""
    n = -(-int(n_bytes) // ALLOC_GRANULE) * ALLOC_GRANULE
    return n + ALLOC_SPLIT if n > ALLOC_SPLIT else n


def incore_resident_bytes(shape, itemsize: int, pad=None,
                          extra: int = 0) -> int:
    """Device bytes one in-core block allocates at once, each tensor
    counted as the allocator may count it (:func:`_allocated`): the input
    grid, the output grid and, where the block pads (``pad``: the ghost
    widths per dim of the ``pad_boundary`` copy K2/K4 read, or the
    oracle's per-application pad), the padded copy; plus ``extra`` more
    tensors the block holds beside them (the oracle's temporaries, a
    staged chain's block input), each counted at the padded copy's size
    (the grid's without ``pad``), which bounds every one of them.  The
    reference compares the grid alone with its budget (``plan.py:558``),
    so a grid between half the budget and the budget was judged to fit
    and then could not."""
    n = math.prod(shape)
    grid = _allocated(n * itemsize)
    padded = grid if pad is None else _allocated(
        math.prod(m + 2 * p for m, p in zip(shape, pad)) * itemsize)
    return 2 * grid + (0 if pad is None else padded) + extra * padded


def _slab_row_bytes(shape: tuple[int, ...], deep_halo: tuple[int, ...],
                    itemsize: int) -> int:
    """Bytes of one outermost-axis row of a slab window: dims 1.. ride
    along whole, ghost-padded ``deep_halo[d]`` on each side."""
    row = itemsize
    for d in range(1, len(shape)):
        row *= shape[d] + 2 * deep_halo[d]
    return row


def slab_resident_bytes(slab_len: int, shape: tuple[int, ...],
                        deep_halo: tuple[int, ...], itemsize: int,
                        extra: int = 0) -> int:
    """Device bytes the slab executor (:mod:`repro_torch.kernels.stream`)
    allocates for slabs of ``slab_len`` rows: a ring of two windows
    (``slab_len + 2*deep_halo[0]`` outermost rows, dims 1.. ghost-padded;
    slab ``k+1`` uploads into one while K2/K4 reads slab ``k`` from the
    other) and a ring of two output slabs (slab ``k`` is written into one
    while slab ``k-1`` downloads from the other), one tensor per ring,
    plus ``extra`` window-sized temporaries the slab's compute holds (0
    for K2/K4, which write into the ring; the oracle's window core for
    ``backend="ref"`` holds several), each counted as the allocator may
    count it (:func:`_allocated`).

    The reference counts ``2*window + out`` (``perfmodel.py:372``): its
    download of slab ``k-1`` is a blocking ``np.asarray`` that frees that
    output before slab ``k+1`` is staged.  Here the download runs on a
    stream of its own beside the upload and the kernel, so the output it
    reads stays allocated while the next one is written."""
    row = _slab_row_bytes(shape, deep_halo, itemsize)
    window = (slab_len + 2 * deep_halo[0]) * row
    out_bytes = slab_len * itemsize * math.prod(shape[1:])
    return (_allocated(2 * window) + _allocated(2 * out_bytes)
            + extra * _allocated(window))


def max_slab_len(shape: tuple[int, ...], deep_halo: tuple[int, ...],
                 itemsize: int, budget: int, extra: int = 0) -> int:
    """Largest outermost slab length whose resident set
    (:func:`slab_resident_bytes`, which grows with the length) fits
    ``budget``, clamped to 1 (a single-row slab cannot shrink, so a
    budget below even that still streams row by row) and to the grid's
    extent."""
    lo, hi = 1, int(shape[0])
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if slab_resident_bytes(mid, shape, deep_halo, itemsize,
                               extra) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


# ----------------------------------------------------------------------------
# The Hopper tile cost model's constants
# ----------------------------------------------------------------------------
#: f64 operations per second without fused multiply-add: half the H100
#: SXM data sheet's 34 TFLOP/s, which counts an FMA as two.  The f64
#: contract forbids contraction, so every product and add is its own
#: instruction (PERF.md §2).
H100_PEAK_FLOPS_F64 = 17e12

#: f32 operations per second without FMA outside the tensor cores: half
#: the data sheet's 67 TFLOP/s.  bf16 grids are widened to f32 on load
#: and computed at this rate.
H100_PEAK_FLOPS_F32 = 33.5e12

# The four constants below were measured or fitted by
# ``tools/tile_probe.py`` on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md
# §6): the L2 rate and the launch floor measured, the per-CTA and
# per-plane-step costs fitted (``--fit``) to the block times of every
# candidate tile on the main-path cases, the other constants at the data
# sheet's values.

#: L2 bytes/s, read+write: a 16 MiB copy, 100 times in one CUDA graph
#: while both buffers stay in L2 (a lower bound: the graph's launch gaps
#: are counted).  The halo each window shares with its neighbours is
#: re-read from L2, not from HBM.
H100_L2_BW = 4.70e12

#: Launch floor of one block (seconds), host wrapper included, timed
#: between CUDA events: half the floor of a block of 64 points (a host pad
#: and a K2 launch).
H100_LAUNCH_S = 4.5e-5

#: Cost of one CTA beyond its work (seconds, charged per CTA of the
#: launch, not per wave): its prologue, barriers and tail, about 8 us of
#: an SM's time at two CTAs per SM.  ``kernels.tune.fit_calibration``
#: fits it on the card as the slope between the measured tiles of the
#: fewest and the most CTAs.
H100_CTA_STEP_S = 3.1e-8

#: Fixed cost of one plane step of the streamed rank-3 kernel (seconds,
#: per CTA): the barrier, the wait for the plane loaded ahead and the
#: ``sweeps`` planes formed one after another by 384 threads, whatever
#: their size.  The plane steps' fixed cost, not the bytes, sets heat3d
#: at about 7x its bytes bound (PERF.md §5 item 2).
H100_PLANE_STEP_S = 2.1e-6

#: CTAs per SM the streamed rank-3 kernel's registers leave room for:
#: 384 threads at over 85 registers each take more than half of an SM's
#: 65,536 (``__launch_bounds__(CASPER_STREAM_THREADS, 1)``).
STREAM_CTAS_PER_SM = 1

# ----------------------------------------------------------------------------
# Measured calibration (CASPER_CALIBRATION)
# ----------------------------------------------------------------------------
#: Environment override of the tile cost model's constants: an inline
#: JSON object or the path of a JSON file (anything that does not start
#: with ``{``).  Keys, all numbers; unknown keys are dropped, so a file
#: can carry provenance fields:
#:
#: * ``gpu_bw``: HBM bytes/s (default :data:`H100_HBM_BW`, 3.35e12);
#: * ``gpu_launch_s``: launch floor per block (:data:`H100_LAUNCH_S`);
#: * ``gpu_cta_step_s``: cost per CTA of a launch (:data:`H100_CTA_STEP_S`);
#: * ``gpu_peak_flops_f32``: f32 operations/s (:data:`H100_PEAK_FLOPS_F32`);
#: * ``gpu_n_sms``: SMs (:data:`H100_SMS`, 132);
#: * ``gpu_peak_flops_f64``: f64 operations/s without FMA
#:   (:data:`H100_PEAK_FLOPS_F64`, 17e12);
#: * ``gpu_l2_bw``: L2 bytes/s (:data:`H100_L2_BW`);
#: * ``gpu_plane_step_s``: the streamed kernel's cost per plane step
#:   (:data:`H100_PLANE_STEP_S`).
#:
#: The first five are the reference's GPU keys, with the H100's defaults.
#: Its ``tpu_*`` keys have nothing to act on here (the port has no TPU
#: model) and are dropped like unknown keys.  Rates must be ``> 0``, keys
#: ending in ``_s`` ``>= 0``; anything else raises ``ValueError``.
CALIBRATION_ENV = "CASPER_CALIBRATION"

_CALIBRATION_KEYS = frozenset((
    "gpu_bw", "gpu_launch_s", "gpu_cta_step_s", "gpu_peak_flops_f32",
    "gpu_n_sms", "gpu_peak_flops_f64", "gpu_l2_bw", "gpu_plane_step_s",
))


@functools.lru_cache(maxsize=32)
def _parse_calibration(raw: str) -> tuple[tuple[str, float], ...]:
    text = raw
    if not raw.lstrip().startswith("{"):
        with open(raw, encoding="utf-8") as fh:
            text = fh.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"{CALIBRATION_ENV} is not valid JSON: {e}") from e
    if not isinstance(data, dict):
        raise ValueError(f"{CALIBRATION_ENV} must be a JSON object")
    out = []
    for key in sorted(data):
        if key not in _CALIBRATION_KEYS:
            continue
        val = float(data[key])
        # rates divide traffic and must be > 0; overheads add, and a
        # measured fit may clamp them to 0
        floor_ok = val >= 0.0 if key.endswith("_s") else val > 0.0
        if not floor_ok or math.isinf(val) or math.isnan(val):
            raise ValueError(
                f"{CALIBRATION_ENV}[{key!r}] must be a finite "
                f"{'non-negative' if key.endswith('_s') else 'positive'} "
                f"number, got {data[key]!r}")
        out.append((key, val))
    return tuple(out)


def calibration() -> dict[str, float]:
    """The measured constants in force: ``CASPER_CALIBRATION`` parsed
    (inline JSON or a file path) and filtered to the recognised keys;
    ``{}`` when it is unset.  Read at call time by the cost functions, so
    a calibration re-ranks tiles without a re-import."""
    return dict(calibration_fingerprint())


def calibration_fingerprint() -> tuple[tuple[str, float], ...]:
    """Hashable identity of the calibration in force: part of the
    autotuner's memo and disk-cache keys (:mod:`repro_torch.kernels.tune`),
    so rankings under different constants never collide.  The plan cache
    key does not carry it, as in the reference: a plan lowered under one
    calibration is served under another."""
    raw = os.environ.get(CALIBRATION_ENV)
    if raw is None or not raw.strip():
        return ()
    return _parse_calibration(raw)


def _cal(key: str, default: float) -> float:
    return calibration().get(key, default)


# ----------------------------------------------------------------------------
# The Hopper tile cost of K1-K4
# ----------------------------------------------------------------------------
def _points_and_flops(spec, tile, sweeps) -> tuple[int, int]:
    """Points formed and operations done by one CTA: every application
    forms ``tile + 2*rem`` points per dim, ``rem`` the ghost depth the
    rest of the block still consumes (the fused halo recompute), each at
    its stage's ``structured_flops_per_point()``."""
    from .stencil import as_stages
    rem = [sweeps * h for h in spec.halo]
    points = flops = 0
    for _ in range(sweeps):
        for st in as_stages(spec):
            rem = [r - h for r, h in zip(rem, st.halo)]
            pts = math.prod(t + 2 * r for t, r in zip(tile, rem))
            points += pts
            flops += pts * st.structured_flops_per_point()
    return points, flops


def cuda_tile_cost(spec, shape, tile, sweeps: int = 1,
                   itemsize: int = 4) -> float:
    """Predicted seconds of one fused block of ``sweeps`` applications of
    ``spec`` on a grid of ``shape`` at kernel tile ``tile`` on an H100,
    for K1-K4 as ``csrc/stencil.cu`` builds them.  The sum of:

    * **feasibility**: ``inf`` when :func:`repro_torch.core.plan.smem_bytes`
      (the exact layout the launch asks for) exceeds one block's
      :data:`H100_SMEM_PER_BLOCK`: the tiles lowering refuses;
    * **residency and waves**: CTAs per SM are the fewer of what the
      registers leave room for (:data:`repro_torch.core.plan.CTAS_PER_SM`,
      the streamed rank-3 kernel :data:`STREAM_CTAS_PER_SM`) and what
      :data:`H100_SMEM_PER_SM` holds at ``smem + 1 KB`` each; the CTAs
      (:func:`repro_torch.core.plan.launch_blocks`) run in waves of SMs x
      resident CTAs, a half-empty last wave costing a whole one;
    * **per CTA, at its share of the card**: the bytes and the
      operations, the larger of the two where two CTAs share an SM (one
      loads while the other computes; the streamed kernel loads planes
      ahead of use), their sum where one CTA holds it alone.  Bytes: the
      CTA's tile read once and written once at the HBM rate (``gpu_bw``);
      the rest of its window, the halo it shares with its neighbours,
      re-read from the 50 MB L2 (``gpu_l2_bw``).  Operations: the points
      each application forms (``tile + 2*(sweeps-1-s)*halo``) times the
      stage's ``structured_flops_per_point()``, without FMA, at the f64
      rate or, for f32 and bf16 (widened), the f32 rate;
    * **overheads**: the launch floor, a cost per CTA and, for the
      streamed kernel, a cost per plane step of each CTA
      (``tile[0] + 2*sweeps*halo[0] + sweeps - 1`` steps), on each wave;
    * **the host pad**: where :func:`repro_torch.core.plan.ghost_strategy_for`
      takes the padded window (K2/K4) for this tile, one more launch and
      the pad's read of the grid and write of the padded copy at the HBM
      rate.

    A grid that does not fill one wave is priced as one of the batch of
    such grids that would (a plan does not know its batch; small grids
    come in batches): its share of the wave, of the launch floors and of
    the pad, and, where one tile covers a grid of rank 1-2, its share of
    a CTA that packs as many grids as shared memory allows
    (:func:`repro_torch.core.plan.pack_factor`).

    Constants from :func:`calibration` (``CASPER_CALIBRATION``)."""
    return _cuda_cost(spec, shape, tile, sweeps, itemsize)


def cuda_pipeline_tile_cost(pipeline, shape, tile, sweeps: int = 1,
                            itemsize: int = 4) -> float:
    """:func:`cuda_tile_cost` of a fused stage chain (K3/K4): the window
    widened by ``sweeps`` times the sum of the stage radii, each stage's
    points formed at its own operations per point."""
    return _cuda_cost(pipeline, shape, tile, sweeps, itemsize)


#: The batch a grid of one tile is priced in: large enough that
#: ``plan.pack_factor`` packs as many grids per CTA as shared memory holds.
_BATCH = 2 ** 24


def _cuda_cost(spec, shape, tile, sweeps, itemsize) -> float:
    from . import plan as _plan        # plan imports this module
    tile = tuple(int(t) for t in tile)
    shape = tuple(int(n) for n in shape)
    smem = _plan.smem_bytes(tile, spec, sweeps, itemsize)
    if smem > H100_SMEM_PER_BLOCK:
        return math.inf
    streamed = _plan.streams(spec)
    resident = min(STREAM_CTAS_PER_SM if streamed else _plan.CTAS_PER_SM,
                   H100_SMEM_PER_SM // (smem + H100_SMEM_RESERVED_PER_BLOCK))
    slots = _cal("gpu_n_sms", H100_SMS) * resident
    ctas = _plan.launch_blocks(shape, tile, 1)
    # a grid smaller than a wave: the share of the batch that fills one
    share = 1.0 if ctas >= slots else ctas / slots
    waves = math.ceil(ctas / slots) if ctas >= slots else share
    bw = _cal("gpu_bw", H100_HBM_BW)
    out = math.prod(tile)
    window = math.prod(t + 2 * sweeps * h for t, h in zip(tile, spec.halo))
    t_mem = slots * (2 * out * itemsize / bw
                     + (window - out) * itemsize
                     / _cal("gpu_l2_bw", H100_L2_BW))
    rate = (_cal("gpu_peak_flops_f64", H100_PEAK_FLOPS_F64) if itemsize == 8
            else _cal("gpu_peak_flops_f32", H100_PEAK_FLOPS_F32))
    t_ops = slots * _points_and_flops(spec, tile, sweeps)[1] / rate
    t_cta = (max(t_mem, t_ops) if resident > 1 or streamed
             else t_mem + t_ops)
    if streamed:
        steps = tile[0] + 2 * sweeps * spec.halo[0] + sweeps - 1
        t_cta += steps * _cal("gpu_plane_step_s", H100_PLANE_STEP_S)
    padded = _plan.ghost_strategy_for(spec, shape, itemsize, sweeps,
                                      tile) == "padded-window"
    pack = 1 if ctas > 1 else _plan.pack_factor(
        spec, shape, tile, sweeps, itemsize, _BATCH, padded=padded)
    launch = _cal("gpu_launch_s", H100_LAUNCH_S)
    cost = share * launch + waves * t_cta \
        + ctas * _cal("gpu_cta_step_s", H100_CTA_STEP_S) / pack
    if padded:
        padded = math.prod(n + 2 * sweeps * h
                           for n, h in zip(shape, spec.halo))
        cost += share * launch + (math.prod(shape) + padded) * itemsize / bw
    return cost


# ----------------------------------------------------------------------------
# Serving: the bucket-close heuristic of the continuous-batching server
# ----------------------------------------------------------------------------
#: Host time one serving bucket costs beyond its device time (seconds):
#: lowering from the cache, stacking into pinned memory, the upload's and
#: download's setup, the wrapper calls that pad and launch its blocks.
#: Measured by ``chip_smoke.py`` phase 3 on an NVIDIA H100 80GB HBM3 at
#: 700.00 W as the wall time of a one-grid bucket through
#: ``plan.BatchHandle`` (jacobi2d (32, 64), iters=8: two host pads and two
#: K2 launches) less the device time a ``torch.profiler`` trace of the
#: same calls shows: the median of five calls' readings, 0.3514, 0.3870,
#: 0.3905, 0.5813 and 0.6194 ms (the host's speed moves between calls;
#: within one call, seven rounds spread 0.341-0.373 ms).  The
#: reference's 150e-6 (``perfmodel.py:701``) was calibrated on a CPU host
#: and is not this card's.
SERVE_DISPATCH_OVERHEAD_S = 3.905e-4

#: Slack on the expected bucket fill time: the submitting host's arrival
#: jitter makes the achieved rate lag the offered one, and a timer set to
#: the nominal fill time closes buckets short.  The reference's 3.0,
#: calibrated on its CPU host (BENCH_8); it describes the submitting
#: host, not the card, and phase 2h logs the achieved over offered rate
#: it is held against.
SERVE_FILL_SLACK = 3.0


def bucket_close_wait_s(offered_rate_rps: float, max_bucket_size: int,
                        *, deadline_s: float | None = None,
                        dispatch_overhead_s: float =
                        SERVE_DISPATCH_OVERHEAD_S) -> float:
    """How long the admission queue holds a bucket open before closing it
    short (``ServeConfig.max_wait_s``), the reference's formula
    (``perfmodel.py:714-750``): the smaller of the expected fill time
    ``SERVE_FILL_SLACK * max_bucket_size / rate`` and the overhead a full
    bucket can amortize, ``max_bucket_size * dispatch_overhead_s``;
    floored at one dispatch overhead and capped at half the SLO budget
    when one is given."""
    if max_bucket_size < 1:
        raise ValueError(
            f"max_bucket_size must be >= 1, got {max_bucket_size}")
    rate = max(float(offered_rate_rps), 1e-9)
    fill_s = SERVE_FILL_SLACK * max_bucket_size / rate
    amortized_s = max_bucket_size * dispatch_overhead_s
    wait = max(min(fill_s, amortized_s), dispatch_overhead_s)
    if deadline_s is not None:
        wait = min(wait, deadline_s / 2.0)
    return wait


# ============================================================================
# The paper's modeled machines (paper §7, Table 2) — not the H100
# ============================================================================
# The first-order bottleneck model behind the paper's Figures 10-13 and
# Tables 5-6, copied from ``repro.core.perfmodel`` float for float.  The
# paper evaluates Casper in gem5; this model re-derives its results from
# Table 2's constants.  Every constant below describes one of the paper's
# machines — a 16-core 2 GHz CPU whose LLC slices each hold one SPU, the
# NVIDIA Titan V of §7.1, the HMC PIMS of §8.4 — and none is this port's
# card (the H100's are the ``H100_*`` names above).  Units: seconds,
# bytes, Joules; one "sweep" is one stencil application over the grid.

# Paper CPU (Table 2)
FREQ = 2.0e9                     # 2 GHz
N_CORES = 16
N_SPUS = 16
N_SLICES = 16
VEC_ELEMS = 8                    # 512-bit SIMD / f64
ELEM = 8                         # bytes per element (double)
LINE = 64                        # bytes per cache line

# Paper CPU: peak f64 FLOP/s, the paper's Fig. 1 horizontal line.
CPU_PEAK_FLOPS = 537.6e9
# Fig. 1: all stencils achieve <20% of peak; stencil compute retires at a
# fraction of peak even when not memory-bound. CALIBRATED to Fig. 1 / [42].
CPU_COMPUTE_EFFICIENCY = 0.25

# Paper CPU cache capacities.
L1_BYTES = 32 * 1024
L2_BYTES = 256 * 1024            # per core
LLC_BYTES = 32 * 1024 * 1024     # shared, 16 slices x 2 MB

# Paper CPU aggregate bandwidths (derived from Table 2 port widths).
L2_BW = N_CORES * 64 * FREQ      # 2048 GB/s: 1 load port x 64 B x 16 cores
LLC_CPU_BW = N_SLICES * 64 * FREQ / 2.0   # CPU-side LLC bw; /2 CALIBRATED
                                          # (NoC round-trip + MSHR limits)
LLC_LOCAL_BW = N_SLICES * 64 * FREQ       # SPU-side: local slice, no NoC
DRAM_BW = 4 * 25.6e9             # 4 x DDR4-3200 channels

# Paper CPU and SPU energies (Table 2).
E_CPU_INSTR = 0.08e-9
E_SPU_INSTR = 0.016e-9
E_L1_HIT, E_L1_MISS = 15e-12, 33e-12
E_L2_HIT, E_L2_MISS = 46e-12, 93e-12
E_L3_HIT, E_L3_MISS = 945e-12, 1904e-12
E_DRAM = 160e-9                  # per 64 B read/write

# Paper Casper: remote-slice service penalty for SPU loads, in cycles of
# extra occupancy per remote vector load (NoC hop + remote slice port
# contention, partially hidden by the 10-entry load queue). CALIBRATED to
# Table 5 3-D rows.
REMOTE_PENALTY_CYCLES = 10.0

# Paper GPU (Titan V, §7.1/§8.3): 652.8 GB/s HBM2, 7.45 f64 TFLOP/s,
# 815 mm^2 — the paper's baseline GPU, not the H100.
GPU_BW = 652.8e9
GPU_PEAK_FLOPS = 7.45e12
GPU_AREA_MM2 = 815.0
GPU_LAUNCH_S = 3.3e-6            # kernel launch + sync floor; CALIBRATED to
                                 # Table 5 GPU L2 rows (~4k cycles @ 1.2 GHz)
GPU_FREQ = 1.2e9                 # for converting Table 5 GPU cycles

# Paper Casper hardware additions (§8.6): 16 SPUs + unaligned-load logic.
CASPER_AREA_MM2 = 16 * 0.146 + 16 * 0.14   # = 4.58 (paper rounds to 4.65)

# Paper PIMS (§8.4): performance bounded by HMC atomic-op throughput
# [156,157]. CALIBRATED so cache-resident speedup averages ~5.5x (Fig. 13).
PIMS_ATOMICS_PER_S = 35e9
PIMS_INTERNAL_BW = 320e9         # HMC internal bandwidth for streaming

# Baseline-CPU pathologies reported in §8.1 that a first-order model cannot
# derive: the Blur2D DRAM dataset suffers prefetcher-induced evictions (LLC
# hit rate 2%, 4x more DRAM accesses). Taken from the paper's own analysis.
CPU_DRAM_TRAFFIC_FACTOR = {"blur2d": 4.0}


def _dataset_level(spec: StencilSpec, shape: tuple[int, ...]) -> str:
    n_bytes = 2 * math.prod(shape) * ELEM          # in + out arrays
    if n_bytes <= N_CORES * L2_BYTES:
        return "L2"
    if n_bytes <= LLC_BYTES:
        return "L3"
    return "DRAM"


@functools.lru_cache(maxsize=256)
def _remote_fraction(spec: StencilSpec, shape: tuple[int, ...],
                     seg: SegmentConfig) -> float:
    """:func:`repro_torch.core.segment.remote_fraction`, memoized: it walks
    every access of the grid, and each table asks for every cell twice."""
    return remote_fraction(spec, shape, seg)


@dataclasses.dataclass(frozen=True)
class SweepCost:
    """One modeled sweep on one of the paper's machines."""

    seconds: float
    energy_j: float
    bottleneck: str
    detail: dict

    @property
    def cycles(self) -> float:
        return self.seconds * FREQ


def cpu_sweep(spec: StencilSpec, shape: tuple[int, ...]) -> SweepCost:
    """One sweep on the paper's baseline CPU (Table 2)."""
    n = math.prod(shape)
    level = _dataset_level(spec, shape)
    flops = 2.0 * spec.n_taps * n
    t_compute = flops / (CPU_PEAK_FLOPS * CPU_COMPUTE_EFFICIENCY)

    # Streaming traffic: read input once, write + write-allocate output.
    traffic = 3.0 * n * ELEM
    times = {"compute": t_compute}
    if level == "L2":
        times["L2"] = traffic / L2_BW
    elif level == "L3":
        times["L2"] = traffic / L2_BW
        times["LLC"] = traffic / LLC_CPU_BW
    else:
        dram_traffic = traffic * CPU_DRAM_TRAFFIC_FACTOR.get(spec.name, 1.0)
        times["L2"] = traffic / L2_BW
        times["LLC"] = traffic / LLC_CPU_BW
        times["DRAM"] = dram_traffic / DRAM_BW
    bottleneck = max(times, key=times.get)
    seconds = times[bottleneck]

    # Energy: per-element L1 work + line-granular traffic down the hierarchy.
    loads_stores = (spec.n_taps + 1) * n
    instrs = 1.4 * loads_stores          # ld/st + MAC + loop overhead mix;
                                         # CALIBRATED to Table 4 CPU rows
    lines = traffic / LINE
    energy = instrs * E_CPU_INSTR + loads_stores * E_L1_HIT
    if level in ("L3", "DRAM"):
        energy += lines * (E_L2_MISS + E_L3_HIT)
    else:
        energy += lines * E_L2_HIT
    if level == "DRAM":
        dram_lines = lines * CPU_DRAM_TRAFFIC_FACTOR.get(spec.name, 1.0)
        energy += dram_lines * (E_L3_MISS - E_L3_HIT) + dram_lines * E_DRAM
    return SweepCost(seconds, energy, bottleneck,
                     {"level": level, "times": times, "instrs": instrs})


def casper_sweep(
    spec: StencilSpec,
    shape: tuple[int, ...],
    program: Program | None = None,
    seg: SegmentConfig | None = None,
    unaligned_hw: bool = True,
) -> SweepCost:
    """One sweep on the paper's Casper (16 SPUs in the LLC slices)."""
    n = math.prod(shape)
    level = _dataset_level(spec, shape)
    program = program or assemble(spec)
    seg = seg or SegmentConfig()
    n_instr = program.n_instrs

    vectors = n / VEC_ELEMS
    loads = program.loads_per_vector()
    vec_loads = loads["with_casper"] if unaligned_hw else loads["without_casper"]

    # Issue/bandwidth term: the SPU pipeline retires one vector op per cycle
    # and its local slice supplies one 64 B window per cycle -> the two rates
    # are matched by construction (§3.1), so cycles/vector = max(instr, loads).
    cyc_per_vec = max(n_instr, vec_loads)

    # Remote-slice accesses (only at block boundaries under the linear hash).
    rf = _remote_fraction(spec, tuple(shape), seg)
    cyc_per_vec += rf * vec_loads * REMOTE_PENALTY_CYCLES

    t_spu = vectors * cyc_per_vec / (N_SPUS * FREQ)
    times = {"spu": t_spu}
    traffic = 3.0 * n * ELEM
    if level == "DRAM":
        times["DRAM"] = traffic / DRAM_BW
    bottleneck = max(times, key=times.get)
    seconds = times[bottleneck]

    # Energy: SPU instructions + per-element LLC accesses (+ DRAM fills).
    llc_accesses = (n_instr + 1) * n     # every tap load + the output store
    energy = (vectors * n_instr * N_SPUS / N_SPUS) * E_SPU_INSTR \
        + llc_accesses * E_L3_HIT
    if level == "DRAM":
        energy += (traffic / LINE) * (E_L3_MISS - E_L3_HIT + E_DRAM)
    return SweepCost(seconds, energy, bottleneck,
                     {"level": level, "times": times,
                      "remote_fraction": rf, "cyc_per_vec": cyc_per_vec})


def gpu_sweep(spec: StencilSpec, shape: tuple[int, ...]) -> SweepCost:
    """One sweep on the paper's Titan V."""
    n = math.prod(shape)
    traffic = 3.0 * n * ELEM
    t = max(GPU_LAUNCH_S, traffic / GPU_BW,
            2.0 * spec.n_taps * n / GPU_PEAK_FLOPS)
    bottleneck = "launch" if t == GPU_LAUNCH_S else "HBM"
    return SweepCost(t, float("nan"), bottleneck, {})


def pims_sweep(spec: StencilSpec, shape: tuple[int, ...]) -> SweepCost:
    """One sweep on the paper's HMC PIMS."""
    n = math.prod(shape)
    atomics = spec.n_taps * n            # one atomic MAC-equivalent per tap
    t_atomic = atomics / PIMS_ATOMICS_PER_S
    t_bw = 3.0 * n * ELEM / PIMS_INTERNAL_BW
    t = max(t_atomic, t_bw)
    return SweepCost(t, float("nan"),
                     "atomics" if t == t_atomic else "internal_bw", {})


def speedup_table() -> dict[str, dict[str, float]]:
    """Fig. 10: Casper speedup over the CPU baseline, per stencil x level
    (the paper's machines, modeled)."""
    out: dict[str, dict[str, float]] = {}
    for name, spec in PAPER_STENCILS.items():
        out[name] = {}
        for level in ("L2", "L3", "DRAM"):
            shape = DOMAIN_SIZES[level][spec.ndim]
            out[name][level] = (cpu_sweep(spec, shape).seconds
                                / casper_sweep(spec, shape).seconds)
    return out


def energy_table() -> dict[str, dict[str, float]]:
    """Fig. 11: Casper energy normalized to the CPU baseline (the paper's
    machines, modeled)."""
    out: dict[str, dict[str, float]] = {}
    for name, spec in PAPER_STENCILS.items():
        out[name] = {}
        for level in ("L2", "L3", "DRAM"):
            shape = DOMAIN_SIZES[level][spec.ndim]
            out[name][level] = (casper_sweep(spec, shape).energy_j
                                / cpu_sweep(spec, shape).energy_j)
    return out


# The paper's reported results for validation (Table 5 cycles -> speedups).
PAPER_TABLE5_CYCLES = {
    # stencil: {level: (cpu, gpu, casper)}
    "jacobi1d": {"L2": (13358, 4030, 4569), "L3": (95251, 36134, 33220),
                 "DRAM": (3838447, 135360, 4370993)},
    "7pt1d": {"L2": (14702, 4108, 8449), "L3": (125138, 36594, 66393),
              "DRAM": (5715526, 139320, 4514872)},
    "jacobi2d": {"L2": (26457, 4646, 7658), "L3": (178032, 37248, 58734),
                 "DRAM": (8720011, 140160, 3931701)},
    "blur2d": {"L2": (95428, 6950, 55764), "L3": (742734, 41318, 446300),
               "DRAM": (22729495, 153480, 5454431)},
    "heat3d": {"L2": (39029, 5184, 29572), "L3": (296436, 36633, 286675),
               "DRAM": (7986968, 140856, 6784185)},
    "star33_3d": {"L2": (115884, 6758, 100243), "L3": (1009021, 52491,
                                                       1385955),
                  "DRAM": (9060219, 278784, 13420984)},
}

PAPER_TABLE6_ENERGY = {
    "jacobi1d": {"L2": (0.00012, 0.000468), "L3": (0.00113, 0.00341),
                 "DRAM": (0.2631221, 0.3114322)},
    "7pt1d": {"L2": (0.000144, 0.000629), "L3": (0.00145, 0.00469),
              "DRAM": (0.28253, 0.59888)},
    "jacobi2d": {"L2": (0.000256, 0.00073), "L3": (0.002, 0.0055),
                 "DRAM": (0.3483945, 0.8809648)},
    "blur2d": {"L2": (0.0009, 0.0015), "L3": (0.0075, 0.0118),
               "DRAM": (0.64639877, 1.19655244)},
    "heat3d": {"L2": (0.000386, 0.001737), "L3": (0.003364, 0.014002),
               "DRAM": (0.469465, 1.4752518)},
    "star33_3d": {"L2": (0.0011542, 0.0028739), "L3": (0.010266, 0.027749),
                  "DRAM": (0.4424779, 1.8090142)},
}

# NOTE: Table 5/6 cycle & energy counts are for the benchmark's full run
# (multiple sweeps + setup); we validate on *ratios* (speedup, normalized
# energy), which cancel the sweep count.


def paper_speedup(stencil: str, level: str) -> float:
    cpu, _, casper = PAPER_TABLE5_CYCLES[stencil][level]
    return cpu / casper


def paper_energy_ratio(stencil: str, level: str) -> float:
    cpu, casper = PAPER_TABLE6_ENERGY[stencil][level]
    return casper / cpu
