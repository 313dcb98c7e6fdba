"""The Hopper constants that lowering reads, and the tile cost model.

Ported here: the budgets :func:`repro_torch.core.plan.lower` and the
kernel wrappers' launch geometry consult, the measured calibration
(``CASPER_CALIBRATION``, the reference's ``perfmodel.py:253-334``) and
the Hopper tile cost of the kernels K1-K4 as ``csrc/stencil.cu`` builds
them (:func:`cuda_tile_cost`, :func:`cuda_pipeline_tile_cost`), which
ranks tiles for ``tile="auto"`` (:mod:`repro_torch.kernels.tune`).  The
Casper/CPU/GPU analytic model of ``repro.core.perfmodel`` (Tables 4-6)
waits for ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import functools
import json
import math
import os

#: H100 SXM device memory, 80 GB (NVIDIA H100 data sheet).  A grid larger
#: than this (or than ``CASPER_SLAB_BUDGET``) would need out-of-core slab
#: streaming, which the port does not have yet (ROADMAP Queue 1 item 7).
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
