"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels K1-K4 (``stencil.cu``) and K5 (all on
the tensor cores: bf16 and f16 on wgmma, ``swa_wgmma.cu``; f32 in three
TF32 passes, ``swa_tf32.cu``) from ``src/repro_torch/kernels/csrc``
(nvcc, one process per source, all three at once, into
``build/repro_torch/``), then:

1. holds each kernel against its plain PyTorch version on the card —
   every paper stencil (plus forced-dense blur2d/star33_3d) and every
   paper pipeline x 4 boundaries x f64/f32/bf16 x sweeps {1,2,4}, on odd
   shapes (rows not 16-byte aligned, mostly rim tiles) and on aligned
   shapes with interior tiles for every case, both kernels per case
   (K1/K2 for a spec, K3/K4 for a pipeline): f64 bitwise, f32 within
   1e-5, bf16 equal or within one bf16 ulp; plus the fuzz regression
   corpus's chains (ranks 1-3), a mixed zero/constant/reflect chain, tiny
   grids, a 2048^2 periodic grid, batched grids and a batch of 70,000 f32
   8x8 grids (past gridDim.y's 65,535); batches of small grids, each one
   fitted tile, packed several to a CTA on all four kernels in every
   dtype, boundary and sweeps (ragged last CTAs among them); rank-3 specs
   run the streamed kernel (planes along dim 0) on both entries; every
   K1-K4 launch counts on the card its interior and rim tiles, its CTAs
   by load kind (16-byte ``cp.async``, a ``cp.async`` per element,
   through registers, with a boundary test) and its packed CTAs, and the
   phase fails unless each kernel, and each entry of the streamed kernel,
   ran both tile kinds, K1, K3 and the streamed K1 ran interior tiles on
   both load paths, K2 and K4 copied windows by both kinds of
   ``cp.async`` and masked ragged ones, each of K1-K4 ran packed and
   unpacked CTAs, and ``plan.smem_bytes`` equals the shared memory each
   launch asked for (``casper_smem_bytes``); and K5 (sliding-window attention) against its
   plain version on a seeded subset of the reference tests' matrix, every
   head dim K5 is built for and tq {32, 64, 128} among them, plus 8 cases
   at softcap <= 2, where |s / softcap| passes 0.55, and head dims 112
   and 192, groups of 24 and 32 query heads per KV head and float16
   (f32 within 2e-5; bf16 within one ulp or 4e-6, whichever is larger, of
   the plain version and of the f32 kernel on the widened inputs; f16
   within one f16 ulp or 4e-6); and K1-K4 at every tile ``tile="auto"``
   gives the main paths below (each case's block and remainder, in every
   dtype on odd and aligned shapes, both entries) and at every other
   candidate of ``plan.HOPPER_TILES`` that fits, for each spec and
   pipeline above (f64); and K2 (ranks 1-3) and K4 on the slab windows the
   slab executor uploads by DMA from pinned memory (``casper_copy_box``),
   each slab's origin inside a taller grid, every boundary mode, f64 and
   f32, with slabs shallower than their overlap among them (each window
   bitwise equal to the oracle's ``pad_boundary`` of the whole grid,
   ``deep_halo`` wide on every dim, cut to the slab's rows; each slab to
   the plain version); and K2 and K4 on shard windows (the global grid's
   ``pad_boundary`` cut to a shard, what the distributed exchange builds)
   with the shard's origin non-zero on every axis, ranks 2 and 3 (K2 on
   the streamed kernel in rank 3, K4 on a rank-3 fuzz chain), every
   boundary mode, f64/f32/bf16, one sweep and a fused block;
2. runs the engine — ``CasperEngine(spec, backend="cuda",
   sweeps=4).run(grid, iters=10)``, all f64, each bitwise equal to
   ``backend="ref"`` on the card, on each main path below, with the launch
   counts reset just before it and read just after:
   (a) single specs at each paper stencil's Table 3 DRAM shape (zero and
   periodic boundary, K1; periodic again with the plan's strategy forced
   to the padded window, K2 and its host pad: a forced row runs its plan
   through ``run_plan`` for 8 iterations, two whole blocks, so that every
   block is the kernel it names) and at jacobi2d 8192^2 and
   heat3d 512x512x256; (b) pipelines: reaction_diffusion2d at 2048^2 and
   8192^2, advect_diffuse2d at 1024^2 and 2048^2 (K3; 2048^2 again forced
   to the padded window, K4), the mixed chain at 2048^2 and a chain that
   cannot fuse at 2048^2 (staged: K1 per stage); (c) sliding-window attention,
   ``kernels.ops.swa`` at gemma2-27b's local-layer width (bf16 at 8192
   and 8000 tokens, f32 and f16 at 8192; K5), each result held against
   K5's plain version and the dense oracle ``swa_ref``; (d) serving
   buckets, a batch of grids per run (the reference's serving mix,
   ``src/repro/serve/loadgen.py``): jacobi2d 8x8 x 70,000, (32, 64) x 48
   and x 4096, jacobi1d (512,) x 4096, reaction_diffusion2d (32, 64) x
   4096 (K2/K4 with the host pad: grids below one window), advect2d
   periodic (32, 64) x 4096 (K1) and heat3d (8, 12, 16) x 4096 (the
   streamed K2); (e) every case of (a), (b) and (d) again through
   ``CasperEngine(..., tile="auto")`` (the Hopper tile cost model picks
   each plan's tile), each f64 result bitwise equal to ``backend="ref"``
   and each kernel of the path launched, with one autotune per distinct
   plan and none for a second identical engine; (f) slab streaming: six
   grids past a forced ``CASPER_SLAB_BUDGET`` (jacobi2d zero 32768^2
   under 2 GiB, periodic 8192^2 under 128 MiB, heat3d 1024x512x512 and
   reaction_diffusion2d 16384^2 under 512 MiB, the staged advect2d ->
   rd_react chain at 8192^2 under 128 MiB, star33_3d reflect with slabs
   shallower than their overlap), each bitwise equal to the same engine
   in core on the card, its result on the host and its peak device
   memory within its budget; two more grids, each just past a budget
   that the old rule (input and output only, one grid of a batch only)
   would have run in core, under the same checks: jacobi2d zero
   1048576x8 (K2's padded copy does not fit) and a batch of 8 jacobi2d
   reflect 2048^2 grids under the in-core block of 3 (run on the card
   three grids at a time); logged with the host's RAM, the host link
   (1 GiB pinned copies each way alone, both at once, and the pitched
   upload), and per case the slabs, the bytes each way, one block's time
   beside its link bound (the larger of the bytes each way over their
   rate and the block's device bound) and the in-core alternative (grid
   up, in-core block, grid down), pinning and staging; one block under
   ``torch.profiler`` must show an H2D copy overlapping a K2 launch and a
   D2H copy (the trace goes to ``build/slab_trace.json``); (g)
   ``backend="vm"`` on the card: every paper stencil and pipeline at its
   Table 3 L2 shape x 4 boundaries, bitwise equal to the VM on the host
   with equal counters and within 1e-12 of ``backend="ref"``, beside the
   paper model's tables (the paper's machines, not the card); (h)
   serving on the card, f64, ``backend="cuda"``, sweeps=4: (i)
   ``StencilServer.serve`` on the reference's mix
   (``loadgen.mixed_requests(8192, seed=7)``) plus 512 requests of each
   paper pipeline at (32, 64), every result bitwise equal to
   ``serve_sequential`` and to ``backend="ref"`` on the card, each
   bucket's launches (served alone, and the whole run's, split by rank
   as the wrappers count them) equal to the launch lint's prediction
   (``analysis.predicted_launches``), requests/s and points/s per
   bucket; (ii) the same mix through ``AsyncStencilServer``
   (``ServeConfig.auto(rate, max_bucket_size=512)``), open loop (Poisson)
   at half (i)'s requests/s, again at half with a queue that admits the
   whole run, and at twice (i)'s: every handle bitwise equal to (i) with
   the whole-run queue, bitwise or shed in the other two, p50/p99
   latency, close reasons, shed count, the worker's busy share and
   achieved over offered rate logged, launches equal to the prediction;
   two consecutive buckets traced (``build/serve_trace.json``; whether
   bucket k+1's upload overlaps bucket k's kernels is logged, not
   gated); (iii) jacobi2d (512, 512)
   buckets past a forced ``CASPER_SLAB_BUDGET`` through both servers: on
   the host, bitwise equal to in core, counted ``slab_streamed``; (i)
   the distributed path: eight ranks spawned over gloo
   (``tests/_dist_world.py``, the mesh a ``DeviceMesh`` on ``"cpu"``,
   every shard on the one card, the exchanges through pinned host
   buffers), each running ``distributed_stencil_fn`` /
   ``CasperEngine.distributed_fn`` with ``backend="cuda"`` (K2/K4 on its
   exchanged window) and ``"ref"``: (i) the reference's matrices at the
   reference's shapes, all in f64 (the six paper stencils on (8,) and
   (4, 2) meshes, the six temporal-blocking cases with multi-hop gathers,
   a sliver mesh and remainders, the 32-case boundary matrix, a fused
   reaction_diffusion2d and a chain that cannot fuse), every gathered
   result bitwise equal to the single-device ``CasperEngine(...).run`` on
   the card and to ``backend="ref"``, sweeps=4 bitwise equal to four
   sweeps=1 steps with at least three times their exchange rounds,
   periodic rounds equal to zero's, and on every rank each run's rounds
   and launches equal to the launch lint's prediction; (ii) full width,
   f64, iters=10, sweeps=4, mesh (4, 2): jacobi2d zero 8192^2 and
   reaction_diffusion2d reflect 8192^2 on ``("sx", "sy")`` and heat3d
   zero 512x512x256 on ``("sx", "sy", None)``, each shard bitwise equal
   to its block of the single-device run, logged per rank with each
   step's wall time, window time (exchange, staging, padding) and kernel
   device time (CUDA events), rounds, launches and peak device memory
   (eight processes share the card: contended times); a rank that fails
   fails the phase.  Every plan of phases 2 and 3 is lowered under
   ``CASPER_VERIFY=strict`` (``repro_torch.analysis``): a finding fails
   the run;
3. times one fused block per phase-2 case with CUDA events (median),
   beside its bound (the larger of one read and one write of the grid at
   the HBM rate and the f64 operations the contract fixes per point and
   application, ``structured_flops_per_point``, at the f64 rate without
   FMA), the plain version, chained ``F.conv``
   (the yardstick, never used by the port) and, for pipelines, the
   staged chain of the port's own K1 launches; and K5 at the 8192-token
   bf16, f16 and f32 shapes beside their operation bounds (useful FLOP
   at the dense bf16 / f16 tensor rate; for f32 three TF32 passes at the
   dense TF32 rate), their plain versions and
   ``F.scaled_dot_product_attention`` with the same band mask (the
   yardstick, never used by the port; f32 with TF32 off); a serving row
   also times its host pad and the same block on the other entry, and
   its conv chain runs the batch as N; then, for ``tile="auto"``, the
   copy bandwidth (1 GiB read and written) and, per phase-2 case, the
   tuned tile's block time beside the default tile's and, on (a) and (b),
   the analytic top 3 (``kernels.tune.measure_tiles``: all in turn, each
   timed call after an untimed one of the same tile), the constants
   ``kernels.tune.fit_calibration`` fits from them and the analytic top
   under those, and ``kernels.tune.autotune_measured`` (stored under
   ``CASPER_TUNE_CACHE`` and served from it once); the phase fails if the
   tuned tile is slower than 1.5x the best measured in this call; and
   for serving, the dispatch overhead per bucket (the wall time of a
   one-grid ``plan.BatchHandle`` bucket less the device time its
   ``torch.profiler`` trace shows, median of 7 rounds:
   ``perfmodel.SERVE_DISPATCH_OVERHEAD_S``),
   a 33-grid bucket unpadded and padded to its tier (64), and the
   48-grid jacobi2d block at the auto tile beside pad-free split tiles.

Prints the card's name and power limit and a ``{"kernels": [...]}`` line
(one entry per kernel and route: K1/K2 of 1-D/2-D specs on the window
kernel, K1/K2 of 3-D specs on the streamed kernel, K3, K4, K5 bf16, f16
and f32; K2 and K4 carry the serving rows under ``rows``; K2, K2 rank 3
and K4 count their phase-2f slab launches; each entry adds the phase-2h
launches its wrapper counted, by rank; K2, K2 rank 3 and K4 add the
phase-2i ranks' launches) before the last line, which is ``{"ok": true, "device": {...}}``.  Full
results go to ``build/chip_smoke.json``.  Exits non-zero, printing
no result, when CUDA is missing or any check fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 20211228
BOUNDARIES = ("zero", "constant(0.75)", "periodic", "reflect")
DTYPES = (torch.float64, torch.float32, torch.bfloat16)
F32_ATOL = 1e-5        # f32 kernel vs plain: same op order, no FMA either way
REPLACES = {                                      # the TPU kernels
    "K1": "src/repro/kernels/engine.py:217",      # _padfree_kernel
    "K2": "src/repro/kernels/engine.py:151",      # _kernel
    "K3": "src/repro/kernels/engine.py:450",      # _padfree_pipeline_kernel
    "K4": "src/repro/kernels/engine.py:434",      # _pipeline_kernel
    "K5": "src/repro/kernels/swa.py:53",          # _kernel
}
# K1/K2 of a 3-D spec run the streamed kernel (casper_stream_kernel),
# those of 1-D/2-D specs the window kernel (casper_chain_kernel): an
# entry each in the kernels line
REPLACES["K1 rank 3"] = REPLACES["K1"]
REPLACES["K2 rank 3"] = REPLACES["K2"]
REPLACES["K1 rank 3 (heat3d)"] = REPLACES["K1"]
SOURCES = {k: "src/repro_torch/kernels/csrc/stencil.cu" for k in REPLACES}
# K5's bf16 and f16 calls run on wgmma (swa_wgmma.cu, one template), its
# f32 calls in three TF32 passes (swa_tf32.cu): an entry each per dtype
SOURCES["K5"] = "src/repro_torch/kernels/csrc/swa_wgmma.cu"
REPLACES["K5 f16"] = REPLACES["K5"]
SOURCES["K5 f16"] = "src/repro_torch/kernels/csrc/swa_wgmma.cu"
REPLACES["K5 f32"] = REPLACES["K5"]
SOURCES["K5 f32"] = "src/repro_torch/kernels/csrc/swa_tf32.cu"

# Data-sheet rates by card (NVIDIA H100 and H200 data sheets, dense rates
# without sparsity): HBM bytes/s, f64 and f32 FLOP/s outside the tensor
# cores, and bf16, TF32 and f16 FLOP/s on the tensor cores.
CARD_RATES = {
    "H100 PCIe": (2.0e12, 25.6e12, 51.2e12, 756e12, 378e12, 756e12),
    "H100 NVL": (3.9e12, 30e12, 60e12, 835e12, 417.5e12, 835e12),
    "H200": (4.8e12, 34e12, 67e12, 989e12, 494.7e12, 989e12),
    "H100": (3.35e12, 34e12, 67e12, 989e12, 494.7e12, 989e12),   # SXM
}

# Sliding-window attention at gemma2-27b's local layers
# (src/repro/configs/gemma2_27b.py: n_heads=32, n_kv=16, d_head=128,
# window=4096, attn_softcap=50.0; 8192-token context, arXiv:2408.00118),
# at the reference kernel's default query tile.
GEMMA2_LOCAL = {"batch": 1, "hq": 32, "hkv": 16, "head_dim": 128,
                "window": 4096, "softcap": 50.0, "tq": 128}
GEMMA2_SEQS = (8192, 8000)
SWA_F32_ATOL = 2e-5     # K5 vs plain in f32: tests/test_kernels.py's bound
# K5 vs plain in bf16: one bf16 ulp, but never less than SWA_BF16_FLOOR.
# Both round an f32 result once, and the two f32 results differ in
# summation order by a gap d (at most 1.8e-6 on an H100, head dims up to
# 256).  Two roundings of values d apart land at most one ulp + d apart,
# which is more than one ulp only where an ulp is below d (outputs that
# cancel, |o| < 2**-12), and there at most 2 d.  The bf16 kernel (tensor
# cores, P.V exact up to order with P as three bf16 terms) is held by the
# same rule against the f32 kernel (three TF32 passes) on the widened
# inputs, a cross-check between the two kernels; they sum in different
# orders, so the bf16 result is not the f32 one rounded bitwise.  f16 is
# held to one f16 ulp by the same rule.
SWA_BF16_FLOOR = 4e-6
SWA_REF_BF16_ATOL = 0.08  # bf16 vs the f32 oracle: tests/test_kernels.py
SWA_CASES = 400         # phase-1 K5 cases drawn from the matrix below
# phase 3, tile="auto": rounds of measure_tiles, and the gate on the auto
# tile against the best measured candidate in the same call (blocks below
# 1 ms move up to 25% between calls, never 1.5x within one)
TUNE_ROUNDS = 15
AUTO_LIMIT = 1.5
# (b, hkv, g, s, d, w, softcap, tq): head dims 112 and 192, groups of 24
# and 32 query heads per KV head; each in f32, bf16 and f16
SWA_WIDE = ((1, 1, 2, 100, 112, 32, 50.0, 64),
            (1, 1, 12, 96, 192, 40, None, 32),
            (1, 2, 32, 64, 64, 16, 50.0, 32), (1, 1, 24, 40, 16, 8, 50.0, 32),
            (2, 1, 4, 128, 112, 128, None, 128),
            (1, 1, 2, 64, 192, 1, 1.0, 64))
# float16 at the built head dims
SWA_MATRIX_F16 = ((1, 2, 2, 100, 16, 32, 50.0, 32),
                  (2, 1, 4, 96, 32, 64, None, 64),
                  (1, 2, 1, 128, 64, 8, 50.0, 128),
                  (1, 1, 2, 100, 128, 100, 2.0, 64),
                  (1, 2, 2, 64, 256, 32, None, 32))
SWA_MATRIX = {"b": (1, 2), "hkv": (1, 2), "g": (1, 2, 4),
              "s": (64, 96, 128, 100), "d": (16, 32, 64, 128, 256),
              "w": (1, 8, 32, 64, None), "softcap": (None, 50.0),
              "tq": (32, 64, 128), "dtype": (torch.float32, torch.bfloat16)}


def log(*args):
    print(*args, flush=True)


def card_rates(name: str):
    for key, rates in CARD_RATES.items():
        if key in name:
            return key, rates
    log(f"note: no data-sheet rates for {name!r}; using H100 SXM's")
    return "H100", CARD_RATES["H100"]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def forced_budget(n_bytes: int):
    """``CASPER_SLAB_BUDGET`` for whatever lowers inside (the plan key
    carries it, so forced plans never collide with default ones)."""
    old = os.environ.get("CASPER_SLAB_BUDGET")
    os.environ["CASPER_SLAB_BUDGET"] = str(int(n_bytes))
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CASPER_SLAB_BUDGET", None)
        else:
            os.environ["CASPER_SLAB_BUDGET"] = old


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of ``fn`` (which returns once its result is on
    the host) over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def randn(shape, dtype, gen):
    return torch.randn(shape, dtype=torch.float64, device="cuda",
                       generator=gen).to(dtype)


def within_bf16_ulp(got, want, floor: float = 0.0, bits: int = 7) -> bool:
    """Every element equal, or one bf16 ulp of ``want`` (or ``floor``,
    where that is larger) apart; ``bits=10`` holds float16 to one f16
    ulp by the same rule (its subnormals, below 2**-14, one ulp of
    2**-24)."""
    g, w = got.double(), want.double()
    mag = w.abs().clamp_min(2.0 ** (-126 if bits == 7 else -14))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return bool(((g - w).abs() <= ulp.clamp_min(floor)).all())


def ptxas_table(text: str, entry: str, key) -> dict:
    """Registers, spills and stack frame per kernel instance, read from
    nvcc's ``-Xptxas -v`` output: ``entry`` matches an instance's mangled
    name and ``key(match)`` names the instance."""
    out, k = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(entry, line)
            k = key(m) if m else None
        elif k is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            out.setdefault(k, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        elif k is not None and "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            out.setdefault(k, {})["registers"] = int(m.group(1))
    return out


def conv_chain(spec, sweeps):
    """The yardstick: ``sweeps`` applications of the spec's stage chain
    as chained F.conv{1,2,3}d, each on an F.pad in its stage's mode
    (cuDNN, TF32 off), a leading batch of grids as N with C = 1.
    Returns ``grid -> result``."""
    from repro_torch import as_stages
    nd = spec.ndim
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    steps = []
    for st in as_stages(spec):
        k = [2 * h + 1 for h in st.halo]
        w = torch.zeros([1, 1] + k, dtype=torch.float64)
        for off, c in st.taps:
            w[(0, 0) + tuple(h + o for h, o in zip(st.halo, off))] = c
        pads = []
        for h in reversed(st.halo):
            pads += [h, h]
        mode = {"zero": "constant", "constant": "constant",
                "periodic": "circular", "reflect": "reflect"}[
                    st.boundary_mode]
        steps.append((w.cuda(), pads, mode, st.boundary_value))

    def run(grid):
        x = grid.reshape((-1, 1) + tuple(grid.shape[grid.ndim - nd:]))
        for _ in range(sweeps):
            for w, pads, mode, value in steps:
                if mode == "constant":
                    xp = F.pad(x, pads, mode="constant", value=value)
                else:
                    xp = F.pad(x, pads, mode=mode)
                x = conv(xp, w.to(x.dtype))
        return x.reshape(grid.shape)
    return run


def trace_events(prof, path):
    """The complete events of a ``torch.profiler`` run, exported as a
    chrome trace to ``path``."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return [e for e in json.load(fh).get("traceEvents", [])
                if e.get("ph") == "X" and "dur" in e]


def spans(events, pred):
    """``(start, end)`` in microseconds of the events ``pred`` keeps."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if pred(e)]


def meet(a, b):
    return a[0] < b[1] and b[0] < a[1]


def busy(iv):
    """Time (us) covered by the union of the intervals ``iv``."""
    total, end = 0.0, -math.inf
    for a, b in sorted(iv):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def is_device(e):
    return e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")


# phase 2h: the reference's serving mix, plus a bucket of each paper
# pipeline at (32, 64), served in f64 at sweeps=4 on backend="cuda"
SERVE_N = 8192
SERVE_PIPE_BUCKET = 512
SERVE_MAX_BUCKET = 512


def bucket_launches(buckets, specs, sizes="size"):
    """The launches the lint predicts for served buckets (their stats),
    keyed by (kernel, rank 3?), and the plans lowered for them."""
    from repro_torch.analysis import predicted_launches
    from repro_torch.core import plan as tplan
    out = {}
    for b in buckets:
        spec = specs[b["spec"]]
        plan = tplan.lower(spec, b["shape"], b["dtype"], backend="cuda",
                           sweeps=4)
        for k, n in predicted_launches(plan, b["iters"],
                                       batch=b[sizes]).items():
            key = (k, spec.ndim == 3)
            out[key] = out.get(key, 0) + n
    return out


def launch_snapshot():
    """The launch counters as they stand: all launches and the rank-3
    ones, per kernel."""
    from repro_torch.kernels import engine as keng
    return dict(keng.LAUNCHES), dict(keng.RANK3_LAUNCHES)


def launches_since(before=None):
    """K1-K4 launches since ``before`` (a :func:`launch_snapshot`; since
    the last reset without one), as the wrappers counted them where they
    launched, keyed by (kernel, rank 3?)."""
    from repro_torch.kernels import engine as keng
    total0, rank30 = before or ({}, {})
    out = {}
    for k, n3 in keng.RANK3_LAUNCHES.items():
        n3 -= rank30.get(k, 0)
        n2 = keng.LAUNCHES[k] - total0.get(k, 0) - n3
        for key, n in (((k, False), n2), ((k, True), n3)):
            if n:
                out[key] = n
    return out


def named(keyed):
    """Launches keyed by (kernel, rank 3?) under printable names."""
    return {k + (" rank 3" if r3 else ""): n for (k, r3), n in keyed.items()}


def serving_phase(failures, smi):
    """Phase 2h: ``StencilServer`` and ``AsyncStencilServer`` on the card
    (see the module docstring).  Returns the phase's record, with its
    launches keyed by (kernel, rank 3?) under ``"launches"``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS
    from repro_torch.core import perfmodel as tpm
    from repro_torch.core import plan as tplan
    from repro_torch.kernels import engine as keng
    from repro_torch.serve import (AsyncStencilServer, ServeConfig,
                                   StencilRequest, StencilServer, loadgen)
    t_phase = time.time()
    rng = np.random.default_rng(SEED)
    reqs = loadgen.mixed_requests(n=SERVE_N, seed=7, dtype=np.float64)
    for name in PAPER_PIPELINES:
        reqs += [StencilRequest(name, rng.standard_normal((32, 64)), 8)
                 for _ in range(SERVE_PIPE_BUCKET)]
    reqs = [reqs[i] for i in rng.permutation(len(reqs))]
    srv = StencilServer(backend="cuda", sweeps=4)
    launches = {}

    def add(keyed):
        """Count a run's measured launches into the kernels line."""
        for k, n in keyed.items():
            launches[k] = launches.get(k, 0) + n

    # (i) one-shot serving: warm (every plan lowered, strict), then timed
    srv.serve(reqs)
    torch.cuda.synchronize()
    keng.reset_launches()
    got, st = srv.serve(reqs)
    torch.cuda.synchronize()
    ran = launches_since()
    add(ran)
    pred = bucket_launches(st.buckets, srv.specs)
    if ran != pred:
        failures.append(f"phase 2h (i): launches {named(ran)} != predicted "
                        f"{named(pred)}")
    seq, st_seq = srv.serve_sequential(reqs)
    want, st_ref = StencilServer(backend="ref", sweeps=4).serve(reqs)
    bad = [i for i, (g, s, w) in enumerate(zip(got, seq, want))
           if not (isinstance(g, torch.Tensor) and g.device.type == "cpu"
                   and torch.equal(g, s) and torch.equal(g, w)
                   and bool(torch.isfinite(g).all()))]
    if bad:
        failures.append(f"phase 2h (i): {len(bad)} of {len(reqs)} results "
                        f"differ from serve_sequential or backend='ref'")
    # each bucket alone: its launches against the lint's prediction
    groups = {}
    for r in reqs:
        groups.setdefault(srv.bucket_key(r), []).append(r)
    per_bucket = []
    for group in groups.values():
        before = launch_snapshot()
        _, bst = srv.serve(group)
        torch.cuda.synchronize()
        delta = named(launches_since(before))
        want_b = named(bucket_launches(bst.buckets, srv.specs))
        per_bucket.append((bst.buckets[0]["spec"], delta, want_b))
        if delta != want_b:
            failures.append(f"phase 2h (i) {bst.buckets[0]['spec']}: "
                            f"launches {delta} != predicted {want_b}")
    log(f"phase 2h (i): StencilServer.serve on {len(reqs)} f64 requests "
        f"({SERVE_N} of the reference's mix, {SERVE_PIPE_BUCKET} per paper "
        f"pipeline), {st.n_buckets} buckets in {st.seconds * 1e3:.2f} ms: "
        f"{st.requests_per_s:.1f} requests/s, {st.points_per_s:.4g} "
        f"points/s; serve_sequential {st_seq.seconds * 1e3:.1f} ms "
        f"({st_seq.requests_per_s:.1f} requests/s); launches {named(ran)}; "
        f"{len(reqs) - len(bad)}/{len(reqs)} bitwise equal to "
        f"serve_sequential and backend='ref' | card {smi}")
    for b in st.buckets:
        pts = b["size"] * math.prod(b["shape"])
        log(f"  2h bucket {b['spec']:20s} {str(b['shape']):12s} x "
            f"{b['size']:5d} iters {b['iters']}: {b['seconds'] * 1e3:8.3f} "
            f"ms, {b['size'] / b['seconds']:.1f} requests/s, "
            f"{pts / b['seconds']:.4g} points/s")
    log(f"  2h per-bucket launches (measured, predicted): {per_bucket}")

    # the first bucket staged by this process (fresh pinned memory), then
    # one more of the same size (the host allocator's cached block)
    jac = [r for r in reqs if r.spec_name == "jacobi2d"]
    bh = tplan.batch_handle(srv.specs["jacobi2d"], "cuda", 4, None, "cuda")
    stage_ms = []
    for _ in range(3):
        s = bh.stage([r.grid for r in jac[:SERVE_MAX_BUCKET]])
        stage_ms.append(s.stage_ms)
        bh.fetch(bh.dispatch(s, 8))

    # (ii) the same mix through AsyncStencilServer, open loop (Poisson):
    # at half (i)'s rate with ServeConfig.auto's default queue, then with
    # a queue that admits the whole run (every request held to (i)'s
    # result), and at twice (i)'s rate with the default queue
    rate = st.requests_per_s
    index = {id(r): i for i, r in enumerate(reqs)}
    async_runs = []
    for label, offered, depth in (("low", rate / 2, None),
                                  ("low, whole-run queue", rate / 2,
                                   len(reqs)),
                                  ("high", 2 * rate, None)):
        cfg = ServeConfig.auto(offered, max_bucket_size=SERVE_MAX_BUCKET,
                               **({} if depth is None
                                  else {"queue_depth": depth}))
        server = AsyncStencilServer(config=cfg, backend="cuda", sweeps=4)
        if not async_runs:
            server.warmup(reqs)
        workload = loadgen.poisson_workload(reqs, offered, seed=5)
        torch.cuda.synchronize()
        keng.reset_launches()
        try:
            t0 = time.perf_counter()
            server.start()
            handles = loadgen.submit_open_loop(server, workload)
            t_submit = time.perf_counter() - t0
            server.drain(timeout=120.0)
        finally:
            server.stop(timeout=120.0)
        ran = launches_since()
        add(ran)
        stats = server.stats()
        pred = bucket_launches(stats.buckets, server.specs, "padded_size")
        if ran != pred:
            failures.append(f"phase 2h (ii) {label}: launches {named(ran)} "
                            f"!= predicted {named(pred)}")
        n_ok = n_shed = 0
        for t, h in zip(workload, handles):
            if not h.wait(60.0):
                failures.append(f"phase 2h (ii) {label}: a handle hung")
                break
            if h.error is None:
                n_ok += torch.equal(h.result(), got[index[id(t.request)]])
            elif h.error.error == "shed" and depth is None:
                n_shed += 1
            else:
                failures.append(f"phase 2h (ii) {label}: {h.error}")
        if n_ok + n_shed != len(handles):
            failures.append(f"phase 2h (ii) {label}: {n_ok} bitwise and "
                            f"{n_shed} shed of {len(handles)}")
        later = [b["stage_ms"] for b in sorted(
            stats.buckets, key=lambda b: b["seq"])[1:]]
        # the worker's share of the window spent on buckets (staging, then
        # dispatch to completion): near 1, the host cannot keep up
        worker_s = sum(b["stage_ms"] / 1e3 + b["seconds"]
                       for b in stats.buckets)
        run = {"label": label, "offered_rps": offered,
               "achieved_rps": len(handles) / t_submit,
               "achieved_over_offered": len(handles) / t_submit / offered,
               "max_wait_s": cfg.max_wait_s,
               "queue_depth": cfg.queue_depth, "n_bitwise": n_ok,
               "n_shed": n_shed, "completed_rps": stats.requests_per_s,
               "window_s": stats.seconds,
               "worker_busy_share": worker_s / max(stats.seconds, 1e-9),
               "latency_s": stats.latency_s,
               "close_reasons": stats.close_reasons,
               "n_buckets": stats.n_buckets, "launches": named(ran),
               "stage_ms_median": statistics.median(later) if later else None}
        async_runs.append(run)
        lat = stats.latency_s or {}
        log(f"phase 2h (ii) {label}: offered {offered:.1f} requests/s, "
            f"achieved {run['achieved_rps']:.1f} "
            f"({run['achieved_over_offered']:.3f} of offered), completed "
            f"{stats.requests_per_s:.1f}/s over {stats.seconds:.4f} s; "
            f"max_wait {cfg.max_wait_s * 1e3:.3f} ms, queue_depth "
            f"{cfg.queue_depth}; latency p50 {lat.get('p50', 0) * 1e3:.3f} "
            f"ms, p99 {lat.get('p99', 0) * 1e3:.3f} ms; close "
            f"{stats.close_reasons}; {n_ok} bitwise, {n_shed} shed of "
            f"{len(handles)}; {stats.n_buckets} buckets, staging median "
            f"{run['stage_ms_median']} ms; worker busy "
            f"{run['worker_busy_share']:.3f} of the window; launches "
            f"{named(ran)} | card {smi}")

    # two consecutive buckets under the profiler: does bucket k+1's
    # upload overlap bucket k's kernels?  (logged, not gated)
    server = AsyncStencilServer(
        config=ServeConfig(max_bucket_size=SERVE_MAX_BUCKET, max_wait_s=60.0),
        backend="cuda", sweeps=4)
    two = [server.submit(r) for r in jac[:2 * SERVE_MAX_BUCKET]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)    # the tracer is running
        torch.cuda.synchronize()
        server.stop(timeout=120.0)
        torch.cuda.synchronize()
    events = trace_events(prof, os.path.join(ROOT, "build",
                                             "serve_trace.json"))
    h2d = sorted(spans(events, lambda e: e.get("cat") == "gpu_memcpy"
                       and "HtoD" in e.get("name", "")))
    kern = sorted(spans(events, lambda e: e.get("cat") == "kernel"
                        and "casper_" in e.get("name", "")))
    k_first = [k for k in kern if h2d and k[0] < h2d[-1][0]]
    overlap = bool(h2d and any(meet(h2d[-1], k) for k in kern))
    trace = {"h2d_copies": len(h2d), "kernels": len(kern),
             "upload_k1_overlaps_kernel_k": overlap,
             "kernels_before_upload_k1": len(k_first),
             "upload_k1_after_kernel_k_us": (h2d[-1][0] - k_first[-1][1]
                                             if k_first else None),
             "all_bitwise": all(torch.equal(h.result(timeout=60),
                                            got[index[id(r)]])
                                for h, r in zip(two,
                                                jac[:2 * SERVE_MAX_BUCKET]))}
    if not trace["all_bitwise"]:
        failures.append("phase 2h (ii) traced buckets: not bitwise")
    log(f"phase 2h (ii): two consecutive buckets traced: {trace}")

    # (iii) a bucket past a forced budget, through both servers: each grid
    # streams in slabs; on the host, bitwise equal to in core
    big = [StencilRequest("jacobi2d", rng.standard_normal((512, 512)), 8)
           for _ in range(4)]
    incore, _ = srv.serve(big)
    budget = 512 * 512 * 8 // 2
    slab = {}
    with forced_budget(budget):
        keng.reset_launches()
        res1, st1 = srv.serve(big)
        torch.cuda.synchronize()
        ran1 = launches_since()
        server = AsyncStencilServer(config=ServeConfig(
            max_bucket_size=len(big), max_wait_s=60.0, pad_buckets=False),
            backend="cuda", sweeps=4)
        keng.reset_launches()
        try:
            hs = [server.submit(r) for r in big]
            server.start()
            server.drain(timeout=120.0)
        finally:
            server.stop(timeout=120.0)
        ran2 = launches_since()
        res2 = [h.result(timeout=60) for h in hs]
        st2 = server.stats()
        pred1 = bucket_launches(st1.buckets, srv.specs)
        pred2 = bucket_launches(st2.buckets, server.specs, "padded_size")
        plan = tplan.lower(srv.specs["jacobi2d"], (512, 512), "float64",
                           backend="cuda", sweeps=4)
    add(ran1)
    add(ran2)
    for label, res, stt, ran, pred in (("serve", res1, st1, ran1, pred1),
                                       ("async", res2, st2, ran2, pred2)):
        ok = all(r.device.type == "cpu" and torch.equal(r, w)
                 for r, w in zip(res, incore))
        slab[label] = {"bitwise": ok, "slab_streamed": stt.n_slab_streamed,
                       "launches": named(ran)}
        if not ok or stt.n_slab_streamed != len(big) or ran != pred:
            failures.append(f"phase 2h (iii) {label}: bitwise {ok}, "
                            f"slab_streamed {stt.n_slab_streamed}, launches "
                            f"{named(ran)} (predicted {named(pred)})")
    log(f"phase 2h (iii): jacobi2d (512, 512) x {len(big)} under a "
        f"{budget / 2**20:.1f} MiB budget ({plan.ghost_strategy}, "
        f"{len(plan.slabs or ())} slabs): {slab}")
    log(f"phase 2h: {time.time() - t_phase:.1f}s; staging of a "
        f"{SERVE_MAX_BUCKET}-grid bucket: first {stage_ms[0]:.3f} ms, then "
        f"{stage_ms[1]:.3f}, {stage_ms[2]:.3f} ms")
    return {"one_shot": {"seconds": st.seconds,
                         "requests_per_s": st.requests_per_s,
                         "points_per_s": st.points_per_s,
                         "buckets": st.buckets,
                         "sequential_s": st_seq.seconds,
                         "n_bitwise": len(reqs) - len(bad)},
            "per_bucket_launches": per_bucket, "async": async_runs,
            "trace": trace, "slab": slab, "stage_ms": stage_ms,
            "launches": launches}


def load_helper(name):
    """A helper module of ``tests/`` by path (a site package may own the
    name ``tests``)."""
    path = os.path.join(ROOT, "tests", f"{name}.py")
    loader = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def distributed_phase(failures, smi, gen):
    """Phase 2i: the distributed path, eight ranks on the card (see the
    module docstring).  Returns the phase's record, with the K2/K4
    launches the ranks counted (``launches``: per kernels-line entry)."""
    import numpy as np
    import repro_torch as rt
    world = load_helper("_dist_world")
    t_phase = time.time()
    out_dir = os.path.join(ROOT, "build", "dist2i")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    single = {}
    for key, desc, shape, axes in world.CHIP_FULL:
        spec = world.build_spec(desc, rt)
        g = randn(shape, torch.float64, gen)
        eng = rt.CasperEngine(spec, backend="cuda", sweeps=world.CHIP_SWEEPS)
        eng.run(g, iters=world.CHIP_SWEEPS)                 # lowers, warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eng.run(g, iters=world.CHIP_ITERS)
        torch.cuda.synchronize()
        single[key] = (time.perf_counter() - t0) * 1e3
        np.save(os.path.join(out_dir, f"{key}_in.npy"), g.cpu().numpy())
        np.save(os.path.join(out_dir, f"{key}_want.npy"), want.cpu().numpy())
        del g, want
        torch.cuda.empty_cache()
    log(f"phase 2i: single-device runs (engine.run, iters="
        f"{world.CHIP_ITERS}, sweeps={world.CHIP_SWEEPS}, the reference "
        f"results) in {time.time() - t_phase:.1f}s: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in single.items()))
    t0 = time.time()
    ranks = world.run_world("chip", 8, out_dir, device="cuda", timeout=600)
    log(f"phase 2i: 8 ranks over gloo ({ranks[0]['mesh']}; exchanges "
        f"through pinned host buffers: {ranks[0]['staged_through_host']}), "
        f"one world in {time.time() - t0:.1f}s | card {smi}")
    n_checks = 0
    for rec in ranks:
        for name, (ok, detail) in rec["checks"].items():
            n_checks += 1
            if not ok:
                failures.append(f"phase 2i rank {rec['rank']} {name}: "
                                f"{detail}")
    n_cases = len(world.cases("float64"))
    log(f"phase 2i (i): {n_cases} cases x (cuda, ref) on every rank; rank 0 "
        f"held the {2 * n_cases} gathered f64 results bitwise against the "
        f"single-device run on the card and backend='ref'; {n_checks} "
        f"checks on 8 ranks, {len(failures)} failed")
    entries = {"K2": 0, "K2 rank 3": 0, "K4": 0}

    def add(launches, rank3):
        extra = {k for k, v in launches.items() if v} - {"K2", "K4"}
        if extra:
            failures.append(f"phase 2i: launched {sorted(extra)} besides "
                            "K2/K4")
        entries["K2"] += launches.get("K2", 0) - rank3.get("K2", 0)
        entries["K2 rank 3"] += rank3.get("K2", 0)
        entries["K4"] += launches.get("K4", 0)
    for rec in ranks:
        i = rec["i"]
        add(i["launches"], i["rank3"])
        if min(i["launches"]["K2"], i["launches"]["K4"]) < 1:
            failures.append(f"phase 2i (i) rank {rec['rank']}: K2/K4 not "
                            f"both launched: {i['launches']}")
        log(f"  2i (i) rank {rec['rank']}: launches "
            f"{ {k: v for k, v in i['launches'].items() if v} } (rank 3: "
            f"{ {k: v for k, v in i['rank3'].items() if v} }), exchange "
            f"{i['exchange']['rounds']} rounds, {i['exchange']['self_copies']}"
            f" self copies, {i['exchange']['bytes_sent']} B sent, "
            f"{i['exchange']['seconds'] * 1e3:.1f} ms")
    full = {}
    for key, desc, shape, axes in world.CHIP_FULL:
        rows = [rec["ii"][key] for rec in ranks]
        for rec, row in zip(ranks, rows):
            add(row["launches"], row["rank3"])
            kname = "K4" if desc[0] == "pipeline" else "K2"
            if not row["launches"].get(kname):
                failures.append(f"phase 2i (ii) {key} rank {rec['rank']}: "
                                f"{kname} never ran: {row['launches']}")
            steps = row["steps"]
            log(f"  2i (ii) {key} rank {rec['rank']}: shard "
                f"{tuple(row['shard'])} tile {row['tile']}, wall "
                f"{row['wall_ms']:.2f} ms for {len(steps)} steps (step ms "
                f"{[round(x['step_ms'], 2) for x in steps]}, window "
                f"(exchange + staging + pad) ms "
                f"{[round(x['window_ms'], 2) for x in steps]}, "
                f"{kname} device ms "
                f"{[round(x['kernel_ms'], 3) for x in steps]}), rounds "
                f"{row['exchange']['rounds']} ({row['exchange']['bytes_sent']}"
                f" B sent), launches {row['launches']}, peak device "
                f"{row['peak_bytes'] / 2**20:.1f} MiB, bitwise "
                f"{row['bitwise_equal_single_device']}")
        kernel = [x["kernel_ms"] for row in rows for x in row["steps"]]
        window = [x["window_ms"] for row in rows for x in row["steps"]]
        full[key] = {
            "shape": list(shape), "grid_axes": list(axes),
            "single_device_ms": single[key],
            "wall_ms_median": statistics.median(r["wall_ms"] for r in rows),
            "wall_ms_max": max(r["wall_ms"] for r in rows),
            "kernel_ms_median": statistics.median(kernel),
            "window_ms_median": statistics.median(window),
            "peak_bytes_max": max(r["peak_bytes"] for r in rows),
            "rounds_per_rank": [r["exchange"]["rounds"] for r in rows],
            "bitwise_equal_single_device": all(
                r["bitwise_equal_single_device"] for r in rows),
            "ranks": rows}
        log(f"phase 2i (ii) {key}: 8 ranks, iters={world.CHIP_ITERS}, "
            f"sweeps={world.CHIP_SWEEPS}, mesh (4, 2): wall median "
            f"{full[key]['wall_ms_median']:.2f} ms (max "
            f"{full[key]['wall_ms_max']:.2f}) against the single-device run's"
            f" {single[key]:.2f} ms; per step median window "
            f"{full[key]['window_ms_median']:.2f} ms, kernel "
            f"{full[key]['kernel_ms_median']:.3f} ms (8 processes share the"
            f" card: contended times); peak device per rank <= "
            f"{full[key]['peak_bytes_max'] / 2**20:.1f} MiB; bitwise "
            f"{full[key]['bitwise_equal_single_device']} | card {smi}")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"phase 2i: {time.time() - t_phase:.1f}s; ranks' K2/K4 launches "
        f"{entries}")
    return {"launches": entries, "full_width": full,
            "ranks_i": [rec["i"] for rec in ranks],
            "checks": n_checks, "seconds": time.time() - t_phase}


def serving_times(smi):
    """Phase 3's serving times: the per-bucket dispatch overhead (the
    host's time per bucket call beyond its device time), the cost of
    padding a 33-grid bucket to its tier, and the 48-grid jacobi2d block
    at the auto tile beside pad-free split tiles."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import PAPER_STENCILS
    from repro_torch.core import plan as tplan
    from repro_torch.serve import StencilRequest, StencilServer
    rng = np.random.default_rng(SEED + 1)
    spec = PAPER_STENCILS["jacobi2d"]
    bh = tplan.batch_handle(spec, "cuda", 4, None, "cuda")
    grids = [rng.standard_normal((32, 64)) for _ in range(64)]
    srv = StencilServer(backend="cuda", sweeps=4)
    one = [StencilRequest("jacobi2d", grids[0], 8)]
    out = {}

    def handle_call(gs):
        return lambda: bh.fetch(bh.dispatch(bh.stage(gs), 8))

    def host_and_device(fn, rounds=7, reps=200):
        """The wall time per call in each of ``rounds`` rounds of
        ``reps`` calls, and the device time per call that a
        ``torch.profiler`` trace of 50 calls shows."""
        walls = [wall_ms(fn, reps, warmup=20) for _ in range(rounds)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        events = trace_events(prof, os.path.join(ROOT, "build",
                                                 "dispatch_trace.json"))
        dev = busy(spans(events, is_device)) / 50 / 1e3
        over = sorted((w - dev) / 1e3 for w in walls)
        return {"wall_ms": walls, "device_ms": dev, "overhead_s_rounds": over,
                "overhead_s": statistics.median(over)}

    out["dispatch"] = d = host_and_device(handle_call(grids[:1]))
    out["dispatch_serve"] = ds = host_and_device(lambda: srv.serve(one))
    log(f"phase 3 serving: dispatch overhead per bucket (BatchHandle "
        f"stage+dispatch+fetch of one jacobi2d (32, 64) grid, iters=8; "
        f"wall per call in 7 rounds of 200, less the traced device time "
        f"{d['device_ms']:.4f} ms): median {d['overhead_s'] * 1e6:.1f} us, "
        f"rounds {[round(o * 1e6, 1) for o in d['overhead_s_rounds']]}; "
        f"StencilServer.serve of one request: median "
        f"{ds['overhead_s'] * 1e6:.1f} us, rounds "
        f"{[round(o * 1e6, 1) for o in ds['overhead_s_rounds']]} | card "
        f"{smi}")
    # padding: 33 grids against the same 33 padded to their tier, 64
    pad = {}
    for n, gs in (("33", grids[:33]), ("64 (33 + 31 pad rows)",
                                       grids[:33] + [grids[0]] * 31)):
        wall = wall_ms(handle_call(gs), 50, warmup=5)
        staged = bh.stage(gs)
        dev_grid = staged.tensor
        torch.cuda.synchronize()
        plan = staged.plan
        pad[n] = {"wall_ms": wall,
                  "device_ms": time_ms(lambda: tplan.run_plan(
                      plan, dev_grid, 8), 50)}
    out["padding"] = pad
    log(f"phase 3 serving: a 33-grid bucket (iters=8) unpadded vs at its "
        f"tier: {pad} | card {smi}")
    # the 48-grid bucket: one block at the auto tile and at pad-free split
    # tiles (Queue 3; logged only)
    g48 = torch.from_numpy(np.stack(grids[:48])).cuda()
    tiles = {}
    for tile in ("auto", (16, 32), (8, 32), (16, 64)):
        plan = tplan.lower(spec, (32, 64), torch.float64, backend="cuda",
                           sweeps=4, tile=tile)
        tiles[str(tile)] = {"tile": list(plan.tile),
                            "strategy": plan.ghost_strategy,
                            "ms": time_ms(lambda: tplan.execute(plan, g48),
                                          50)}
    out["tiles48"] = tiles
    log(f"phase 3 serving: jacobi2d (32, 64) x 48, one block (sweeps=4): "
        f"{tiles} | card {smi}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.time()
    from repro_torch import (CasperEngine, DOMAIN_SIZES, PAPER_PIPELINES,
                             PAPER_STENCILS, StencilPipeline)
    from repro_torch.core import perfmodel as tpm
    from repro_torch.core import plan as tplan
    from repro_torch.core import ref as tref
    from repro_torch.core import vm as tvm
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine as keng
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stream as kstream
    from repro_torch.kernels import swa as kswa
    from repro_torch.kernels import tune as ktune
    # the fuzz corpus's chains
    pipeline_cases = load_helper("_pipeline_cases")
    REGRESSION_CORPUS = pipeline_cases.REGRESSION_CORPUS
    random_pipeline = pipeline_cases.random_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card_kind = torch.cuda.get_device_name(0)
    rate_key, (hbm_bw, peak_f64, peak_f32, peak_bf16_tc, peak_tf32_tc,
               peak_f16_tc) = card_rates(card_kind)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | rates of {rate_key}: {hbm_bw:.3g} B/s, f64 {peak_f64:.3g}, "
        f"f32 {peak_f32:.3g}, tensor bf16 {peak_bf16_tc:.3g}, TF32 "
        f"{peak_tf32_tc:.3g}, f16 {peak_f16_tc:.3g} FLOP/s")

    # ---- setup: build every kernel source from the checkout -------------
    t0 = time.time()
    paths = _build.build_all()
    log(f"build: {time.time() - t0:.1f}s -> {[str(p) for p in paths.values()]}")
    for src, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"  {src}: {line.strip()}")
    storage = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16"}
    chain_budget = ptxas_table(
        _build.BUILD_LOGS.get("stencil.cu", ""),
        r"casper_chain_kernelI(d|f|13__nv_bfloat16)Li(\d)E",
        lambda m: f"{storage[m.group(1)]} rank {m.group(2)}")
    for key, budget in chain_budget.items():
        log(f"  stencil.cu casper_chain_kernel {key}: {budget} (shared "
            "memory is dynamic: plan.smem_bytes per launch, held below)")
    if len(chain_budget) != 9:
        raise SystemExit(f"setup: {len(chain_budget)} stencil kernel "
                         "instances in the build log, expected 9")
    stream_budget = ptxas_table(
        _build.BUILD_LOGS.get("stencil.cu", ""),
        r"casper_stream_kernelI(d|f|13__nv_bfloat16)E",
        lambda m: f"{storage[m.group(1)]} rank 3 streamed")
    for key, budget in stream_budget.items():
        log(f"  stencil.cu casper_stream_kernel {key}: {budget}")
    if len(stream_budget) != 3:
        raise SystemExit(f"setup: {len(stream_budget)} streamed stencil "
                         "kernel instances in the build log, expected 3")
    # K5 per dtype and head dim: bf16/f16 instances of swa_tc_kernel,
    # f32 instances of swa_tf32_kernel
    k5_types = {"13__nv_bfloat16": "bf16", "6__half": "f16"}
    tc_budget = ptxas_table(
        _build.BUILD_LOGS.get("swa_wgmma.cu", ""),
        r"swa_tc_kernelILi(\d+)E(13__nv_bfloat16|6__half)E",
        lambda m: f"{k5_types[m.group(2)]} D={m.group(1)}")
    tc_budget.update(ptxas_table(
        _build.BUILD_LOGS.get("swa_tf32.cu", ""),
        r"swa_tf32_kernelILi(\d+)E", lambda m: f"f32 D={m.group(1)}"))
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float16, "f16"),
                         (torch.float32, "f32")):
        for d in kswa.HEAD_DIMS:
            key = f"{label} D={d}"
            tc_budget.setdefault(key, {})["smem_bytes"] = kswa.tc_smem_bytes(
                d, dtype)
            log(f"  K5 {kswa._ENTRY[dtype][0]} {key}: {tc_budget[key]}"
                + ("" if dtype == torch.float32 else
                   " (registers at entry; the consumers run at 232 after "
                   "setmaxnreg.inc)"))
    if len(tc_budget) != 3 * len(kswa.HEAD_DIMS) or not all(
            "registers" in b for b in tc_budget.values()):
        raise SystemExit(f"setup: K5 instances in the build logs: "
                         f"{sorted(tc_budget)}, expected bf16, f16 and f32 "
                         f"at D={kswa.HEAD_DIMS}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    max_err = {k: 0.0 for k in REPLACES}
    swa_err = {torch.float32: 0.0, torch.bfloat16: 0.0, torch.float16: 0.0}
    failures = []

    def is_pipe(spec):
        return isinstance(spec, StencilPipeline)

    def compare(kernel, got, want, dtype, label):
        err = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0.0
        max_err[kernel] = max(max_err[kernel], err)
        floor = 0.0
        if kernel == "K5":
            swa_err[dtype] = max(swa_err[dtype], err)
            floor = SWA_BF16_FLOOR
        if dtype == torch.float64:
            ok = torch.equal(got, want)
        elif dtype == torch.float32:
            ok = err <= (SWA_F32_ATOL if kernel == "K5" else F32_ATOL)
        elif dtype == torch.float16:
            ok = within_bf16_ulp(got, want, floor, bits=10)
        else:
            ok = within_bf16_ulp(got, want, floor)
        if not (ok and got.shape == want.shape and got.dtype == want.dtype
                and bool(torch.isfinite(got).all())):
            failures.append(f"{label}: {kernel} err {err}")
        return err

    def plain_block(spec, g, tile, sweeps, strategy):
        """The plain version of the kernel ``strategy`` selects."""
        n_shape = tuple(g.shape[-spec.ndim:])
        if strategy == "pad-free":
            fn = (keng.pipeline_sweep_plain if is_pipe(spec)
                  else keng.stencil_sweep_plain)
            return lambda: fn(spec, g, tile, sweeps)
        wide = tuple(sweeps * h for h in spec.halo)
        fn = (keng.pipeline_window_sweep_plain if is_pipe(spec)
              else keng.stencil_window_sweep_plain)

        def plain():
            window = tref.pad_boundary(g, wide, spec.boundary_mode,
                                       spec.boundary_value)
            return fn(spec, window, n_shape, (0,) * spec.ndim, n_shape, tile,
                      sweeps)
        return plain

    def run_kernel(spec, grid, sweeps, strategy, label, dtype, tile=None):
        """The kernel ``strategy`` selects at ``tile`` (None: the default
        tile, fitted to the grid) against its plain version."""
        before = dict(keng.LAUNCHES)
        sweep = keng.pipeline_sweep if is_pipe(spec) else keng.stencil_sweep
        got = sweep(spec, grid, tile=tile, sweeps=sweeps, strategy=strategy)
        torch.cuda.synchronize()
        ran = [k for k in keng.LAUNCHES if keng.LAUNCHES[k] != before[k]]
        if len(ran) != 1:
            failures.append(f"{label}: launched {ran}")
            return None
        tile = tplan.normalize_tile(spec, tile, sweeps, grid.element_size(),
                                    grid.shape[-spec.ndim:])
        if strategy is None:
            strategy = tplan.ghost_strategy_for(
                spec, grid.shape[-spec.ndim:], grid.element_size(), sweeps,
                tile)
        err = compare(ran[0], got, plain_block(spec, grid, tile, sweeps,
                                               strategy)(), dtype, label)
        if tplan.streams(spec):
            key = f"{ran[0]} rank 3"
            max_err[key] = max(max_err[key], err)
        return ran[0]

    # ---- phase 1: each kernel vs its plain version ----------------------
    t0 = time.time()
    # odd shapes (rows not 16-byte aligned: the plain load path, mostly
    # rim tiles) and aligned ones, whose inner extent is a whole number of
    # 16-byte chunks in every dtype and which hold interior tiles for every
    # paper stencil and pipeline at every sweeps (the cp.async path for
    # f32/f64)
    odd = {1: (10007,), 2: (77, 301), 3: (37, 45, 101)}
    # rank 3: deep enough for interior tiles of the streamed kernel's
    # 32-plane chunks at sweeps=4
    aligned = {1: (20480,), 2: (160, 512), 3: (72, 80, 96)}
    keng.count_tiles(True)
    specs = [(n, s) for n, s in PAPER_STENCILS.items()]
    specs += [(f"{n}-dense", PAPER_STENCILS[n].with_structure("dense"))
              for n in ("blur2d", "star33_3d")]
    # rank-3 separable specs beside star33_3d: factored terms of three,
    # two and one factors on the streamed kernel's offset tables
    specs += [(s.name, s) for s in pipeline_cases.separable_3d_specs()]
    specs += [(n, p) for n, p in PAPER_PIPELINES.items()]
    n_cases = 0
    keng.reset_launches()
    for label, spec0 in specs:
        for boundary in BOUNDARIES:
            spec = spec0.with_boundary(boundary)
            for dtype, shapes in itertools.product(DTYPES, (odd, aligned)):
                g = randn(shapes[spec.ndim], dtype, gen)
                for sweeps in (1, 2, 4):
                    for strategy in ("pad-free", "padded-window"):
                        run_kernel(spec, g, sweeps, strategy,
                                   f"{label} {boundary} {dtype} "
                                   f"{tuple(g.shape)} s{sweeps}", dtype)
                        n_cases += 1
    rd = PAPER_PIPELINES["reaction_diffusion2d"]
    mixed = StencilPipeline("mixed_rd", (
        rd.stages[0].with_boundary("zero"),
        rd.stages[1].with_boundary("constant(0.75)"),
        rd.stages[0].with_boundary("reflect")))
    # the main paths' cases (phase 2), here because phase 1 holds the
    # kernels at the tiles tile="auto" gives them.  (a) every paper stencil
    # at its Table 3 DRAM shape: zero (K1), periodic (K1: no host pad),
    # and periodic forced to the padded window (K2 with its pad_boundary
    # gather), which tiny grids, shards and slabs still need
    cases = []
    for n, spec in PAPER_STENCILS.items():
        shape = DOMAIN_SIZES["DRAM"][spec.ndim]
        cases.append((n, spec, shape, "DRAM"))
        cases.append((n, spec.with_boundary("periodic"), shape, "DRAM"))
        cases.append((n, spec.with_boundary("periodic"), shape, "DRAM",
                      "padded-window"))
    cases.append(("jacobi2d", PAPER_STENCILS["jacobi2d"], (8192, 8192),
                  "HBM"))
    cases.append(("heat3d", PAPER_STENCILS["heat3d"], (512, 512, 256),
                  "HBM"))
    # (b) pipelines
    nonfusable = StencilPipeline("advect_react", (
        PAPER_PIPELINES["advect_diffuse2d"].stages[0], rd.stages[1]))
    ad = PAPER_PIPELINES["advect_diffuse2d"]
    pcases = [("reaction_diffusion2d", rd, (2048, 2048), "DRAM"),
              ("reaction_diffusion2d", rd, (8192, 8192), "HBM"),
              ("advect_diffuse2d", ad, (2048, 2048), "DRAM"),
              ("advect_diffuse2d", ad, (2048, 2048), "DRAM", "padded-window"),
              ("advect_diffuse2d", ad, (1024, 1024), "L3"),
              ("mixed_rd", mixed, (2048, 2048), "DRAM"),
              ("advect_react", nonfusable, (2048, 2048), "DRAM")]
    # (d) serving: batches of small grids, one launch per fused block (the
    # reference's serving mix, src/repro/serve/loadgen.py: BENCH_5's
    # shapes; a bucket of 48 jacobi2d requests and buckets of 4096), and
    # 70,000 grids of 8x8
    advect2d = PAPER_PIPELINES["advect_diffuse2d"].stages[0]
    scases = [("jacobi2d", PAPER_STENCILS["jacobi2d"], (70000, 8, 8),
               "serving"),
              ("jacobi2d", PAPER_STENCILS["jacobi2d"], (48, 32, 64),
               "serving"),
              ("jacobi2d", PAPER_STENCILS["jacobi2d"], (4096, 32, 64),
               "serving"),
              ("jacobi1d", PAPER_STENCILS["jacobi1d"], (4096, 512), "serving"),
              ("reaction_diffusion2d", rd, (4096, 32, 64), "serving"),
              ("advect2d", advect2d, (4096, 32, 64), "serving"),
              ("heat3d", PAPER_STENCILS["heat3d"], (4096, 8, 12, 16),
               "serving")]
    chains = [(f"corpus seed {c[0]}", random_pipeline(*c[:4]), c[4])
              for c in REGRESSION_CORPUS]
    for label, pipe, sweeps in chains + [("mixed_rd", mixed, 1),
                                         ("mixed_rd", mixed, 2),
                                         ("mixed_rd", mixed, 4)]:
        for dtype, shapes in itertools.product(DTYPES, (odd, aligned)):
            g = randn(shapes[pipe.ndim], dtype, gen)
            for strategy in ("pad-free", "padded-window"):
                run_kernel(pipe, g, sweeps, strategy,
                           f"{label} {dtype} {tuple(g.shape)} s{sweeps}",
                           dtype)
                n_cases += 1
    log(f"phase 1: {n_cases} kernel-vs-plain cases on odd shapes "
        f"{list(odd.values())} and aligned shapes {list(aligned.values())}, "
        f"launches {dict(keng.LAUNCHES)}, max |err| {max_err} "
        f"({time.time() - t0:.1f}s)")
    tiny = {1: (5,), 2: (3, 7), 3: (2, 3, 5)}
    extra = [(f"tiny {n}", PAPER_STENCILS[n].with_boundary(b), tiny[
        PAPER_STENCILS[n].ndim], 1, 4)
        for n in ("7pt1d", "blur2d", "star33_3d") for b in BOUNDARIES]
    extra += [(f"tiny {n}", p.with_boundary(b), tiny[2], 1, 4)
              for n, p in PAPER_PIPELINES.items() for b in BOUNDARIES]
    extra.append(("periodic jacobi2d past the old 12.5 MB budget",
                  PAPER_STENCILS["jacobi2d"].with_boundary("periodic"),
                  (2048, 2048), 1, 4))
    extra += [(f"batched {n}", PAPER_STENCILS[n].with_boundary("reflect"),
               odd[PAPER_STENCILS[n].ndim], 3, 4)
              for n in ("jacobi1d", "jacobi2d", "heat3d")]
    extra += [("batched mixed_rd", mixed, odd[2], 3, 4),
              ("batched advect_diffuse2d", PAPER_PIPELINES[
                  "advect_diffuse2d"], odd[2], 3, 4),
              ("batched star33_3d", PAPER_STENCILS["star33_3d"].with_boundary(
                  "periodic"), odd[3], 2, 4)]
    for label, spec, shape, batch, sweeps in extra:
        shape = (batch,) + shape if batch > 1 else shape
        g = randn(shape, torch.float64, gen)
        kernel = run_kernel(spec, g, sweeps, None, label, torch.float64)
        log(f"  {label} {shape} s{sweeps}: plan chose "
            f"{kernel}, equal to plain: "
            f"{not any(f.startswith(label) for f in failures)}")
    # batches of small grids, each one fitted tile: several grids per CTA
    # on both entries (K1-K4), ragged last CTAs, padded windows inside
    # their input copied by 16-byte cp.async (aligned rows) or by a
    # cp.async per element (unaligned), and tiles whose rounded row
    # crosses the input's end (masked)
    small = {1: (((13,), 23), ((60,), 50)),
             2: (((9, 11), 7), ((8, 8), 70))}
    n_packed = 0
    for label, spec0 in ([(n, PAPER_STENCILS[n]) for n in
                          ("jacobi1d", "7pt1d", "jacobi2d", "blur2d")]
                         + [(n, p) for n, p in PAPER_PIPELINES.items()]):
        for boundary in BOUNDARIES:
            spec = spec0.with_boundary(boundary)
            for dtype, (shape, batch) in itertools.product(
                    DTYPES, small[spec.ndim]):
                g = randn((batch,) + shape, dtype, gen)
                for sweeps in (1, 2, 4):
                    for strategy in ("pad-free", "padded-window"):
                        run_kernel(spec, g, sweeps, strategy,
                                   f"packed {label} {boundary} {dtype} "
                                   f"{batch}x{shape} s{sweeps}", dtype)
                        n_packed += 1
    # serving buckets: 600 grids of (32, 64), two to five per CTA
    for spec in (PAPER_STENCILS["jacobi2d"], rd):
        for dtype in DTYPES:
            g = randn((600, 32, 64), dtype, gen)
            for strategy in ("pad-free", "padded-window"):
                run_kernel(spec, g, 4, strategy, f"packed {spec.name} "
                           f"{dtype} 600x(32, 64) s4", dtype)
                n_packed += 1
    log(f"phase 1: {n_packed} cases of small grids packed several to a CTA"
        f", max |err| {max_err}")
    # a batch past gridDim.y's 65,535: 70,000 f32 grids of 8x8, one launch
    label = "batch of 70000"
    g = randn((70000, 8, 8), torch.float32, gen)
    for strategy in ("pad-free", "padded-window"):
        kernel = run_kernel(
            PAPER_STENCILS["jacobi2d"].with_boundary("reflect"), g, 4,
            strategy, label, torch.float32)
        log(f"  {label} (8, 8) f32 s4 {strategy}: {kernel}, within "
            f"{F32_ATOL} of plain: "
            f"{not any(f.startswith(label) for f in failures)}")
    del g
    # the tiles tile="auto" gives the main paths (phase 2e: each case's
    # block of 4 sweeps and remainder of 2, f64; a staged chain's stages
    # at 1), each kernel at them on the odd and aligned shapes in every
    # dtype and on both entries; then a sample of the other candidates
    # (every fitted HOPPER_TILES entry that fits, of every spec and
    # pipeline above at sweeps=4, one boundary each in turn, f64)
    t0 = time.time()
    tuned = {}
    for c in cases + pcases + scases:
        gshape = tuple(c[2][len(c[2]) - c[1].ndim:])
        if is_pipe(c[1]) and not c[1].fusable:
            runs = [(st, 1) for st in c[1].stages]
        else:
            runs = [(c[1], 4), (c[1], 2)]
        for spec, sw in runs:
            tuner = ktune.autotune_pipeline if is_pipe(spec) else ktune.autotune
            tile = tuner(spec, gshape, sw, 8).tile
            tuned.setdefault((spec, tile), set()).add(sw)
    n_tuned = 0
    for (spec, tile), sws in tuned.items():
        for dtype, shapes in itertools.product(DTYPES, (odd, aligned)):
            g = randn(shapes[spec.ndim], dtype, gen)
            for sw in sorted(sws):
                for strategy in ("pad-free", "padded-window"):
                    run_kernel(spec, g, sw, strategy,
                               f"tuned {spec.name} {tile} {dtype} "
                               f"{tuple(g.shape)} s{sw}", dtype, tile)
                    n_tuned += 1
    n_sampled = 0
    for i, (label, spec0) in enumerate(specs + [("mixed_rd", mixed)]):
        spec = spec0.with_boundary(BOUNDARIES[i % 4]) \
            if label != "mixed_rd" else spec0
        for shapes in (odd, aligned):
            g = randn(shapes[spec.ndim], torch.float64, gen)
            for tile in ktune.candidate_tiles(spec.ndim, g.shape, spec=spec,
                                              sweeps=4, itemsize=8):
                if tplan.smem_bytes(tile, spec, 4, 8) \
                        > tplan._pm.H100_SMEM_PER_BLOCK:
                    continue
                for strategy in ("pad-free", "padded-window"):
                    run_kernel(spec, g, 4, strategy,
                               f"candidate {label} "
                               f"{getattr(spec, 'boundary', '')} {tile} "
                               f"{tuple(g.shape)}", torch.float64, tile)
                    n_sampled += 1
    log(f"phase 1: {n_tuned} cases at the {len(tuned)} tuned tiles of the "
        f"main paths ({sorted({t for _, t in tuned})}), {n_sampled} at the "
        f"other candidates, max |err| {max_err} ({time.time() - t0:.1f}s)")
    # slab windows (phase 2f's path): K2 of ranks 1-3 and K4 on the
    # windows the slab executor builds on the card (DMAs of the mapped
    # host rows from pinned memory, fill rows and ghosts on the device),
    # each with its slab's origin inside a taller grid; every boundary
    # mode, f64 and f32, under a budget of a few slabs and under one that
    # makes the overlap deeper than a slab (slabs of 1-2 rows); each
    # plan's first two, middle and last two slabs.  Each window is held
    # bitwise against the oracle's pad_boundary of the whole grid
    # (deep_halo wide on every dim) cut to the slab's rows, each slab
    # against the kernel's plain version.
    slab_specs = [(PAPER_STENCILS["jacobi1d"], (4099,)),
                  (PAPER_STENCILS["blur2d"], (203, 97)),
                  (PAPER_STENCILS["heat3d"], (70, 19, 45)),
                  (PAPER_STENCILS["star33_3d"], (90, 40, 44)),
                  (rd, (150, 66)), (ad, (150, 66))]
    n_slab = 0
    deep_slabs = 0
    up = torch.cuda.Stream()
    for spec0, shape in slab_specs:
        for boundary, dtype in itertools.product(
                BOUNDARIES, (torch.float64, torch.float32)):
            spec = spec0.with_boundary(boundary)
            host = randn(shape, dtype, gen).cpu()
            pinned = host.pin_memory()
            isz = host.element_size()
            deep = tuple(4 * h for h in spec.halo)
            padded = tref.pad_boundary(host, deep, spec.boundary_mode,
                                       spec.boundary_value)
            for budget in (host.numel() * isz,
                           tpm.slab_resident_bytes(2, shape, deep, isz)):
                with forced_budget(budget):
                    plan = tplan.lower(spec, shape, dtype, backend="cuda",
                                       sweeps=4)
                if not plan.streams_from_host:
                    failures.append(f"phase 1 slab {spec.name} {shape}: "
                                    f"{plan.ghost_strategy} under {budget}")
                    continue
                k = len(plan.slabs)
                for j in sorted({0, 1, k // 2, k - 2, k - 1} & set(range(k))):
                    start, stop = plan.slabs[j]
                    ov = plan.slab_overlap
                    deep_slabs += stop - start < ov
                    label = (f"phase 1 slab {spec.name} {boundary} {dtype} "
                             f"{shape} slab {j}/{k} rows [{start}, {stop}) "
                             f"overlap {ov}")
                    w = kstream._empty_window(plan, stop - start + 2 * ov,
                                              "cuda")
                    up.wait_stream(torch.cuda.current_stream())  # the fill
                    with torch.cuda.stream(up):
                        kstream._upload(plan, pinned, w, start, stop, up)
                    up.synchronize()
                    if not torch.equal(w.cpu(),
                                       padded[start:stop + 2 * ov]):
                        failures.append(f"{label}: window != the padded "
                                        "grid's rows")
                        continue
                    out_shape = (stop - start,) + tuple(shape[1:])
                    origin = (start,) + (0,) * (spec.ndim - 1)
                    fn, pfn = ((keng.pipeline_window_sweep,
                                keng.pipeline_window_sweep_plain)
                               if is_pipe(spec) else
                               (keng.stencil_window_sweep,
                                keng.stencil_window_sweep_plain))
                    kname = "K4" if is_pipe(spec) else "K2"
                    err = compare(kname, fn(spec, w, out_shape, origin, shape,
                                            plan.tile, 4),
                                  pfn(spec, w, out_shape, origin, shape,
                                      plan.tile, 4), dtype, label)
                    if tplan.streams(spec):
                        max_err["K2 rank 3"] = max(max_err["K2 rank 3"], err)
                    n_slab += 1
    log(f"phase 1: {n_slab} slab-window cases (K2 ranks 1-3, K4; windows "
        f"uploaded by DMA, {deep_slabs} with the overlap deeper than the "
        f"slab), max |err| K2 {max_err['K2']}, K2 rank 3 "
        f"{max_err['K2 rank 3']}, K4 {max_err['K4']}")
    if not deep_slabs:
        failures.append("phase 1 slab: no slab shallower than its overlap")
    # shard windows (phase 2i's path): K2 and K4 on the window a rank's
    # exchange builds (the global grid's pad_boundary, deep_halo wide,
    # cut to the shard: what core.halo's exchange returns, as the CPU
    # tests hold), with the shard's origin non-zero on axis 1 (rank 2) and
    # on axes 1 and 2 (rank 3) as well as axis 0; every boundary mode,
    # f64/f32/bf16, one sweep and a fused block, against the plain version
    shard_specs = [
        (PAPER_STENCILS["jacobi2d"], (46, 75), (2, 3), (1, 4)),
        (PAPER_STENCILS["blur2d"], (46, 75), (2, 3), (1, 4)),
        (rd, (46, 75), (2, 3), (1, 4)), (ad, (46, 75), (2, 3), (1, 4)),
        (PAPER_STENCILS["heat3d"], (24, 30, 44), (2, 3, 2), (1, 4)),
        (PAPER_STENCILS["star33_3d"], (24, 30, 44), (2, 3, 2), (1, 2)),
        (random_pipeline(42, 3, False, 2), (24, 30, 44), (2, 3, 2), (1, 2))]
    n_shard = 0
    for spec0, shape, split, sweeps_of in shard_specs:
        nd = len(shape)
        shard = tuple(n // k for n, k in zip(shape, split))
        coords = ([(1, 1), (1, 2), (0, 2)] if nd == 2
                  else [(1, 1, 1), (0, 2, 1), (1, 0, 1)])
        for boundary, dtype, sweeps in itertools.product(
                BOUNDARIES, DTYPES, sweeps_of):
            spec = spec0.with_boundary(boundary)
            g = randn(shape, dtype, gen)
            deep = tuple(sweeps * h for h in spec.halo)
            padded = tref.pad_boundary(g, deep, spec.boundary_mode,
                                       spec.boundary_value)
            fn, pfn = ((keng.pipeline_window_sweep,
                        keng.pipeline_window_sweep_plain)
                       if is_pipe(spec) else
                       (keng.stencil_window_sweep,
                        keng.stencil_window_sweep_plain))
            kname = "K4" if is_pipe(spec) else "K2"
            tile = tplan.normalize_tile(spec, None, sweeps,
                                        g.element_size(), shard)
            for c in coords:
                origin = tuple(k * n for k, n in zip(c, shard))
                w = padded[tuple(slice(o, o + n + 2 * d) for o, n, d in
                                 zip(origin, shard, deep))].contiguous()
                label = (f"phase 1 shard {spec.name} {boundary} {dtype} "
                         f"{shape} origin {origin} s{sweeps}")
                err = compare(kname, fn(spec, w, shard, origin, shape, tile,
                                        sweeps),
                              pfn(spec, w, shard, origin, shape, tile,
                                  sweeps), dtype, label)
                if tplan.streams(spec):
                    max_err["K2 rank 3"] = max(max_err["K2 rank 3"], err)
                n_shard += 1
    log(f"phase 1: {n_shard} shard-window cases (K2 ranks 2-3, K4 ranks "
        f"2-3; origins non-zero on every axis), max |err| K2 "
        f"{max_err['K2']}, K2 rank 3 {max_err['K2 rank 3']}, K4 "
        f"{max_err['K4']}")
    # every launch so far: its tiles by kind, its load path, and its
    # shared memory (the C library's) against plan.smem_bytes
    tiles, stream_tiles = {}, {}
    smem_bad = []
    records = keng.tile_records()
    keng.count_tiles(False)
    for r in records:
        for table in (tiles, stream_tiles) if r["stream"] else (tiles,):
            t = table.setdefault(r["kernel"], {}).setdefault(
                r["path"], {"launches": 0, "interior": 0, "rim": 0})
            t["launches"] += 1
            t["interior"] += r["interior"]
            t["rim"] += r["rim"]
        if r["smem_launch"] != r["smem_plan"]:
            smem_bad.append(r)
    for kernel in ("K1", "K2", "K3", "K4"):
        log(f"  {kernel} tiles by load path: {tiles.get(kernel)}")
        kinds = tiles.get(kernel, {}).values()
        if not (sum(t["interior"] for t in kinds)
                and sum(t["rim"] for t in kinds)):
            failures.append(f"phase 1 {kernel}: never ran an interior and "
                            f"a rim tile: {tiles.get(kernel)}")
    for kernel in ("K1", "K3"):
        if set(tiles.get(kernel, {})) != {"async", "plain"} or not all(
                t["interior"] for t in tiles[kernel].values()):
            failures.append(f"phase 1 {kernel}: interior tiles did not run "
                            f"on both load paths: {tiles.get(kernel)}")
    # the window kernel's CTAs by load kind and packing (streamed
    # launches apart): K2/K4 copied windows inside their input by 16-byte
    # and per-element cp.async and masked ragged ones; every kernel ran
    # packed and unpacked CTAs
    window_ctas = {}
    for kernel in ("K1", "K2", "K3", "K4"):
        kinds = {k: sum(r["loads"][k] for r in records
                        if r["kernel"] == kernel and not r["stream"])
                 for k in keng.LOAD_KINDS}
        ctas = sum(kinds.values())
        packed = sum(r["packed"] for r in records
                     if r["kernel"] == kernel and not r["stream"])
        log(f"  {kernel} CTAs by load kind {kinds}, packed {packed} of "
            f"{ctas}, pack factors "
            f"{sorted({r['pack'] for r in records if r['kernel'] == kernel})}")
        window_ctas[kernel] = {**kinds, "packed": packed}
        if not 0 < packed < ctas:
            failures.append(f"phase 1 {kernel}: packed {packed} of {ctas} "
                            "CTAs: not both packed and unpacked")
        want = ("async16", "elem", "tested") if kernel in ("K2", "K4") \
            else ("async16", "plain", "tested")
        if not all(kinds[k] for k in want):
            failures.append(f"phase 1 {kernel}: a load kind never ran: "
                            f"{kinds}")
    # the streamed rank-3 kernel: both entries, interior and rim tiles,
    # and K1's interior planes on both load paths
    for kernel in ("K1", "K2"):
        log(f"  {kernel} streamed (rank 3) tiles by load path: "
            f"{stream_tiles.get(kernel)}")
        kinds = stream_tiles.get(kernel, {}).values()
        if not (sum(t["interior"] for t in kinds)
                and sum(t["rim"] for t in kinds)):
            failures.append(f"phase 1 {kernel} streamed: never ran an "
                            f"interior and a rim tile: "
                            f"{stream_tiles.get(kernel)}")
    if set(stream_tiles.get("K1", {})) != {"async", "plain"} or not all(
            t["interior"] for t in stream_tiles["K1"].values()):
        failures.append(f"phase 1 K1 streamed: interior tiles did not run "
                        f"on both load paths: {stream_tiles.get('K1')}")
    log(f"  shared memory: {len(records)} launches, plan.smem_bytes equal to "
        f"the launch's (casper_smem_bytes) in {len(records) - len(smem_bad)}")
    if smem_bad:
        failures.append(f"phase 1: plan.smem_bytes != launch: {smem_bad[:3]}")

    cross_err = [0.0]

    def swa_cross_check(got, q, k, v, w, tq, softcap, label):
        """A bf16 K5 result (wgmma) must lie within one bf16 ulp, or
        SWA_BF16_FLOOR, of the f32 K5 (three TF32 passes) on the widened
        inputs."""
        f32 = kswa.sliding_window_attention(q.float(), k.float(), v.float(),
                                            w, tq, softcap)
        cross_err[0] = max(cross_err[0],
                           (got.double() - f32.double()).abs().max().item())
        if not within_bf16_ulp(got, f32, SWA_BF16_FLOOR):
            failures.append(f"{label}: bf16 K5 (wgmma) not within "
                            f"one ulp / {SWA_BF16_FLOOR} of f32 K5 (TF32)")

    def swa_case(b, hkv, g, s, d, w, softcap, tq, dtype):
        label = (f"K5 b{b} hkv{hkv} g{g} s{s} d{d} w{w} cap{softcap} "
                 f"tq{tq} {dtype}")
        q = randn((b, hkv * g, s, d), dtype, gen)
        k = randn((b, hkv, s, d), dtype, gen)
        v = randn((b, hkv, s, d), dtype, gen)
        before = keng.LAUNCHES["K5"]
        got = kswa.sliding_window_attention(q, k, v, w, tq, softcap)
        torch.cuda.synchronize()
        if keng.LAUNCHES["K5"] != before + 1:
            failures.append(f"{label}: {keng.LAUNCHES['K5'] - before} "
                            "K5 launches")
        compare("K5", got, kswa.sliding_window_attention_plain(
            q, k, v, w, tq, softcap), dtype, label)
        if dtype == torch.bfloat16:
            swa_cross_check(got, q, k, v, w, tq, softcap, label)

    # K5 vs its plain version on a seeded subset of the reference matrix
    t0 = time.time()
    matrix = list(itertools.product(*SWA_MATRIX.values()))
    pick = torch.randperm(len(matrix), generator=torch.Generator()
                          .manual_seed(SEED))[:SWA_CASES].sort().values
    n_swa = 0
    drawn = {"d": set(), "tq": set()}
    for i in pick.tolist():
        b, hkv, g, s, d, w, softcap, tq, dtype = matrix[i]
        w = s if w is None else w
        drawn["d"].add(d)
        drawn["tq"].add(tq)
        swa_case(b, hkv, g, s, d, w, softcap, tq, dtype)
        n_swa += 1
    # softcaps of 2 and below reach |s / softcap| > 0.55, where the bf16
    # kernel takes tanhf instead of its polynomial (softcap 50 never does)
    for d, softcap in ((16, 0.5), (64, 2.0), (128, 1.0), (256, 1.0)):
        for dtype in (torch.float32, torch.bfloat16):
            swa_case(1, 2, 2, 100, d, 32, softcap, 64, dtype)
            n_swa += 1
    # what the card used to refuse: head dims 112 (zamba2_7b) and 192
    # (nemotron4_340b, 12 query heads per KV head), 24 and 32 query heads
    # per KV head (the tensor-core kernels split the group over CTAs), and
    # float16 (the bf16 kernel's template on f16, P in scaled f16 terms)
    for case in SWA_WIDE:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            swa_case(*case, dtype)
            n_swa += 1
    for case in SWA_MATRIX_F16:
        swa_case(*case, torch.float16)
        n_swa += 1
    for key, values in drawn.items():
        if values != set(SWA_MATRIX[key]):
            failures.append(f"phase 1 K5: {key} drew {sorted(values)} of "
                            f"{SWA_MATRIX[key]}")
    log(f"phase 1: {n_swa} K5-vs-plain cases ({SWA_CASES} of {len(matrix)}, "
        f"8 at softcap <= 2, {3 * len(SWA_WIDE)} at head dims 112/192 and "
        f"G = 24/32, {len(SWA_MATRIX_F16)} more in f16; head dims "
        f"{sorted(drawn['d'])}, tq {sorted(drawn['tq'])}), max |err| f32 "
        f"{swa_err[torch.float32]} (limit {SWA_F32_ATOL}), bf16 "
        f"{swa_err[torch.bfloat16]} (one ulp, at least {SWA_BF16_FLOOR}), "
        f"f16 {swa_err[torch.float16]} (one f16 ulp, at least "
        f"{SWA_BF16_FLOOR}), "
        f"bf16 (wgmma) vs f32 (three TF32 passes) K5 {cross_err[0]} "
        f"({time.time() - t0:.1f}s)")
    if failures:
        raise SystemExit("phase 1 failed:\n" + "\n".join(failures[:40]))

    # ---- phase 2: the engine, counted per main path -----------------------
    # every plan phases 2 and 3 lower is verified for the card's device
    # string (repro_torch.analysis): a finding raises
    os.environ["CASPER_VERIFY"] = "strict"
    from repro_torch import analysis as tanalysis
    from repro_torch.analysis import launch_lint as tlint
    verified0 = tanalysis.counters()["verifications"]
    def plan_of(eng, case, g):
        """The engine's plan for a case; a case that names a strategy
        (``padded-window``: K2/K4 on a row the plan now sends to K1/K3)
        runs the same plan with that strategy."""
        plan = eng.plan_for(tplan._grid_shape_for(case[1], g), g.dtype)
        if len(case) > 4:
            plan = dataclasses.replace(plan, ghost_strategy=case[4])
        return plan

    def iters_of(case):
        """10 through ``CasperEngine.run`` (two blocks of 4 and one of
        2); a forced row runs 8, two whole blocks of its forced plan, so
        that no remainder block re-lowers to the default strategy."""
        return 8 if len(case) > 4 else 10

    def drive(cases, label, tile=None):
        """Run each case once with the counts reset just before and read
        just after: through ``CasperEngine.run``, or a forced row's plan
        through ``run_plan``; then hold each result against
        ``backend="ref"`` on the card.  ``tile``: the engines' tile
        request (None: the default tile; "auto": the autotuner's)."""
        grids = [randn(c[2], torch.float64, gen) for c in cases]
        engines = [CasperEngine(c[1], backend="cuda", sweeps=4, tile=tile)
                   for c in cases]
        plans = [plan_of(eng, c, g) for eng, c, g in zip(engines, cases,
                                                         grids)]
        torch.cuda.synchronize()
        t0 = time.time()
        keng.reset_launches()
        outs, per_run = [], []
        for c, eng, g, plan in zip(cases, engines, grids, plans):
            before = dict(keng.LAUNCHES)
            outs.append(tplan.run_plan(plan, g, iters_of(c)) if len(c) > 4
                        else eng.run(g, iters=iters_of(c)))
            per_run.append({k: keng.LAUNCHES[k] - before[k]
                            for k in keng.LAUNCHES
                            if keng.LAUNCHES[k] != before[k]})
        torch.cuda.synchronize()
        launches = dict(keng.LAUNCHES)
        log(f"phase 2{label}: engine.run(iters=10, sweeps=4) on {len(cases)} "
            f"grids (forced rows: their plan, iters=8) in "
            f"{time.time() - t0:.2f}s; launches {launches}")
        results = []
        for c, g, out, k, eng in zip(cases, grids, outs, per_run, engines):
            n, spec, shape, level = c[:4]
            want = CasperEngine(spec, backend="ref").run(g,
                                                         iters=iters_of(c))
            equal = torch.equal(out, want)
            finite = bool(torch.isfinite(out).all())
            boundary = getattr(spec, "boundary", None) or "+".join(
                s.boundary for s in spec.stages)
            if not (equal and finite and tuple(out.shape) == tuple(shape)):
                failures.append(f"phase 2{label} {n} {boundary} {shape}: "
                                f"equal {equal} finite {finite}")
            plan = plan_of(eng, c, g)
            results.append({"stencil": n, "boundary": boundary,
                            "shape": list(shape), "level": level,
                            "kernel": kernel_of(plan),
                            "tile": None if plan.tile is None
                            else list(plan.tile),
                            "iters": iters_of(c),
                            "bitwise_equal_ref": equal,
                            "launches_per_run": k})
            del want
        del outs
        log(f"phase 2{label}: {sum(r['bitwise_equal_ref'] for r in results)}"
            f"/{len(results)} bitwise equal to backend='ref' on the card")
        return grids, plans, results, launches

    def kernel_of(plan):
        return "staged" if not plan.fused else tlint.kernel_of(plan)

    grids, plans, results, launches = drive(cases, "a")
    if min(launches[k] for k in ("K1", "K2")) < 1:
        raise SystemExit(f"phase 2a: a kernel of the path never ran: "
                         f"{launches}")
    pgrids, pplans, presults, plaunches = drive(pcases, "b")
    if min(plaunches[k] for k in ("K1", "K3", "K4")) < 1:
        raise SystemExit(f"phase 2b: a kernel of the path never ran: "
                         f"{plaunches}")
    sgrids, splans, sresults, slaunches = drive(scases, "d")
    if sum(slaunches.values()) < len(scases):
        raise SystemExit(f"phase 2d: a kernel of the path never ran: "
                         f"{slaunches}")
    # (e) tile="auto": the same cases through engines that tune their
    # tiles; one autotune per distinct plan (a forced row reuses its
    # periodic row's), none for a second identical engine
    at0 = tplan.plan_cache_stats()
    auto_runs = {}
    for key, cs, paths in (("a", cases, ("K1", "K2")),
                           ("b", pcases, ("K1", "K3", "K4")),
                           ("d", scases, ())):
        got = drive(cs, f"e (2{key}, tile='auto')", tile="auto")
        auto_runs[key] = got
        if any(got[3][k] < 1 for k in paths) or sum(got[3].values()) < 1:
            failures.append(f"phase 2e ({key}): a kernel of the path never "
                            f"ran: {got[3]}")
        for c, r, r_auto in zip(cs, {"a": results, "b": presults,
                                     "d": sresults}[key], got[2]):
            log(f"  2e {c[0]} {r['boundary']} {tuple(c[2])}"
                f"{' forced ' + c[4] if len(c) > 4 else ''}: tile "
                f"{r['tile']} (default) -> {r_auto['tile']} (auto), "
                f"{r_auto['kernel']}, launches {r_auto['launches_per_run']}")
    at1 = tplan.plan_cache_stats()
    auto_plans = [k for k in tplan.PLAN_CACHE.keys()
                  if k[5] == "auto" and k[3] == "cuda"
                  and getattr(k[0], "fusable", True)]
    tuned_here = at1["autotune_calls"] - at0["autotune_calls"]
    log(f"phase 2e: autotune_calls {tuned_here} for {len(auto_plans)} "
        f"distinct tile='auto' plans (lowers {at1['lowers'] - at0['lowers']})")
    if tuned_here != len(auto_plans):
        failures.append(f"phase 2e: {tuned_here} autotunes for "
                        f"{len(auto_plans)} plans")
    for key, cs in (("a", cases), ("b", pcases), ("d", scases)):
        for c, g in zip(cs, auto_runs[key][0]):
            CasperEngine(c[1], backend="cuda", sweeps=4,
                         tile="auto").run(g, iters=10)
    torch.cuda.synchronize()
    at2 = tplan.plan_cache_stats()
    log(f"phase 2e: second identical engines: autotune_calls "
        f"{at2['autotune_calls'] - at1['autotune_calls']}, lowers "
        f"{at2['lowers'] - at1['lowers']}")
    if (at2["autotune_calls"], at2["lowers"]) != (at1["autotune_calls"],
                                                   at1["lowers"]):
        failures.append("phase 2e: a second identical engine lowered or "
                        "tuned again")
    # the card against the host oracle on a small input
    small = randn((37, 45, 101), torch.float64, gen)
    spec = PAPER_STENCILS["star33_3d"].with_boundary("reflect")
    got = CasperEngine(spec, backend="cuda", sweeps=4).run(small, iters=10)
    if not torch.equal(got.cpu(), tref.run_iterations(spec, small.cpu(), 10)):
        failures.append("phase 2: card != host oracle (star33_3d reflect)")
    small = randn((77, 301), torch.float64, gen)
    got = CasperEngine(mixed, backend="cuda", sweeps=4).run(small, iters=10)
    if not torch.equal(got.cpu(), tref.run_pipeline(mixed, small.cpu(), 10)):
        failures.append("phase 2: card != host oracle (mixed_rd)")
    log(f"phase 2: card == host oracle on star33_3d reflect (37,45,101) and "
        f"mixed_rd (77,301): {'phase 2: card' not in ' '.join(failures)}")
    if failures:
        raise SystemExit("phase 2 failed:\n" + "\n".join(failures))

    # ---- phase 2f: grids past the device budget, streamed in slabs ------
    t0 = time.time()
    with open("/proc/meminfo") as fh:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024
               for line in fh if line.startswith(("MemTotal",
                                                  "MemAvailable"))}
    dev_free, dev_total = torch.cuda.mem_get_info()
    log(f"phase 2f: host RAM {mem.get('MemTotal', 0) / 2**30:.1f} GiB, "
        f"{mem.get('MemAvailable', 0) / 2**30:.1f} GiB available; device "
        f"{dev_free / 2**30:.1f} of {dev_total / 2**30:.1f} GiB free | card "
        f"{smi}")

    def link_rates():
        """The host link, 1 GiB pinned copies (median of 5): each way
        alone, both at once on two streams (each way's bytes over the
        pair's time), and the slab executor's pitched upload (rows of
        8192 doubles into windows 8200 wide, ``casper_copy_box``)."""
        n = 2 ** 27
        hb = [torch.empty(n, dtype=torch.float64, pin_memory=True)
              for _ in range(2)]
        db = [torch.empty(n, dtype=torch.float64, device="cuda")
              for _ in range(2)]
        s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
        padded = torch.empty((n // 8192, 8200), dtype=torch.float64,
                             device="cuda")

        def both():
            with torch.cuda.stream(s1):
                db[0].copy_(hb[0], non_blocking=True)
            with torch.cuda.stream(s2):
                hb[1].copy_(db[1], non_blocking=True)

        def pitched():
            kstream._copy_rows(padded[:, 4:8196], hb[0].view(-1, 8192), s1)
        gib = 2 ** 30
        out = {
            "h2d_Bps": gib / wall_ms(
                lambda: db[0].copy_(hb[0], non_blocking=True), 5) * 1e3,
            "d2h_Bps": gib / wall_ms(
                lambda: hb[1].copy_(db[1], non_blocking=True), 5) * 1e3,
            "both_each_Bps": gib / wall_ms(both, 5) * 1e3,
            "pitched_h2d_Bps": gib / wall_ms(pitched, 5) * 1e3,
        }
        del hb, db, padded
        torch.cuda.empty_cache()
        return out

    link = link_rates()
    log(f"phase 2f: link (1 GiB pinned copies): H2D {link['h2d_Bps'] / 1e9:.2f}"
        f" GB/s, D2H {link['d2h_Bps'] / 1e9:.2f} GB/s alone; both at once "
        f"{link['both_each_Bps'] / 1e9:.2f} GB/s each way; pitched H2D "
        f"(casper_copy_box) {link['pitched_h2d_Bps'] / 1e9:.2f} GB/s | card "
        f"{smi}")
    star = PAPER_STENCILS["star33_3d"].with_boundary("reflect")
    star_shape = (80, 48, 56)
    # (label, spec, shape, budget): every case sweeps=4, iters=10 (two
    # blocks and a remainder of 2)
    fcases = [
        ("jacobi2d zero", PAPER_STENCILS["jacobi2d"], (32768, 32768),
         2 * 2 ** 30),
        ("jacobi2d periodic", PAPER_STENCILS["jacobi2d"].with_boundary(
            "periodic"), (8192, 8192), 128 * 2 ** 20),
        ("heat3d zero", PAPER_STENCILS["heat3d"], (1024, 512, 512),
         512 * 2 ** 20),
        ("reaction_diffusion2d", rd, (16384, 16384), 512 * 2 ** 20),
        ("advect2d -> rd_react (staged)", nonfusable, (8192, 8192),
         128 * 2 ** 20),
        ("star33_3d reflect", star, star_shape,
         tpm.slab_resident_bytes(4, star_shape, (8, 8, 8), 8)),
    ]
    hosts, wants = [], []
    for label, spec, shape, budget in fcases:
        g = randn(shape, torch.float64, gen)
        host = torch.empty(shape, dtype=torch.float64, pin_memory=True)
        host.copy_(g)
        del g
        # the same engine in core on the card, without the forced budget
        want = CasperEngine(spec, backend="cuda", sweeps=4).run(host, 10)
        wants.append(want.cpu())
        hosts.append(host)
        del want
        torch.cuda.empty_cache()
    log(f"phase 2f: inputs and in-core runs of {len(fcases)} cases in "
        f"{time.time() - t0:.1f}s")
    fresults = []
    keng.reset_launches()
    for (label, spec, shape, budget), host, want in zip(fcases, hosts,
                                                        wants):
        with forced_budget(budget):
            eng = CasperEngine(spec, backend="cuda", sweeps=4)
            plan = eng.plan_for(shape, torch.float64)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = dict(keng.LAUNCHES)
            t1 = time.perf_counter()
            out = eng.run(host, iters=10)
            torch.cuda.synchronize()
            run_ms = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated() - base
            # a staged chain's slabs are its stage plans'
            slab_plan = (plan if plan.streams_from_host
                         else plan.stage_plan(0))
            streams = plan.needs_host_streaming
        staging = dict(kstream.LAST_RUN)
        equal = out.device.type == "cpu" and torch.equal(out, want)
        grid_bytes = host.numel() * 8
        r = {"case": label, "spec": spec.name, "shape": list(shape),
             "grid_bytes": grid_bytes, "budget": budget,
             "strategy": plan.ghost_strategy,
             "slabs": len(slab_plan.slabs or ()),
             "slab_len": (slab_plan.slabs[0][1] - slab_plan.slabs[0][0]
                          if slab_plan.slabs else None),
             "overlap": slab_plan.slab_overlap, "tile": slab_plan.tile,
             "bitwise_equal_in_core": equal,
             "result_device": str(out.device), "peak_device_bytes": peak,
             "run_ms": run_ms, "staging": staging,
             "launches_per_run": {k: keng.LAUNCHES[k] - before[k]
                                  for k in keng.LAUNCHES
                                  if keng.LAUNCHES[k] != before[k]}}
        fresults.append(r)
        if not (equal and out.device.type == "cpu" and peak <= budget
                and streams):
            failures.append(f"phase 2f {label} {shape}: equal {equal}, "
                            f"result on {out.device}, peak {peak} of "
                            f"budget {budget}, {plan.ghost_strategy}")
        del out
    flaunches = dict(keng.LAUNCHES)
    log(f"phase 2f: engine.run(iters=10, sweeps=4) on {len(fcases)} grids "
        f"past their forced budgets; launches {flaunches}; "
        f"{sum(r['bitwise_equal_in_core'] for r in fresults)}/{len(fresults)}"
        " bitwise equal to the in-core run on the card")
    if min(flaunches[k] for k in ("K2", "K4")) < 1:
        failures.append(f"phase 2f: a kernel of the path never ran: "
                        f"{flaunches}")
    del wants
    # the in-core decision's repairs, each grid just past a budget that
    # the old rule (input and output of one grid) ran in core: a grid
    # narrower than a window, whose K2 padded copy does not fit beside its
    # input and output, and a batch whose grids fit one at a time but not
    # together (run on the card a part of the batch at a time)
    j2 = PAPER_STENCILS["jacobi2d"]
    narrow = (1 << 20, 8)
    rcases = [("jacobi2d zero, K2's padded copy", j2, narrow,
               tpm.incore_resident_bytes(narrow, 8) + 32 * 2 ** 20),
              ("jacobi2d reflect, batch of 8", j2.with_boundary("reflect"),
               (8, 2048, 2048), None)]
    rresults = []
    for label, spec, shape, budget in rcases:
        g = randn(shape, torch.float64, gen).cpu()
        want = CasperEngine(spec, backend="cuda", sweeps=4).run(g, 10).cpu()
        if budget is None:              # the in-core block of 3 grids
            budget = tplan.incore_device_bytes(tplan.lower(
                spec, shape[1:], torch.float64, backend="cuda", sweeps=4), 3)
        torch.cuda.empty_cache()
        with forced_budget(budget):
            eng = CasperEngine(spec, backend="cuda", sweeps=4)
            plan = eng.plan_for(shape[-2:], torch.float64)
            on_host = tplan.stays_on_host(plan, g)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            out = eng.run(g, iters=10)
            torch.cuda.synchronize()
            run_ms = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated() - base
        equal = out.device.type == "cpu" and torch.equal(out, want)
        r = {"case": label, "shape": list(shape), "budget": budget,
             "grid_bytes": g.numel() * 8, "strategy": plan.ghost_strategy,
             "slabs": len(plan.slabs or ()), "stays_on_host": on_host,
             "bitwise_equal_in_core": equal, "peak_device_bytes": peak,
             "run_ms": run_ms}
        rresults.append(r)
        log(f"  2f {label:30s} {str(tuple(shape)):18s} grid "
            f"{r['grid_bytes'] / 2**20:.0f} MiB, budget "
            f"{budget / 2**20:.1f} MiB: {plan.ghost_strategy}, "
            f"{r['slabs']} slabs, on the host {on_host}, peak device "
            f"{peak / 2**20:.1f} MiB, bitwise equal to in core {equal}, "
            f"run(iters=10) {run_ms:.1f} ms | card {smi}")
        if not (equal and on_host and peak <= budget):
            failures.append(f"phase 2f {label} {shape}: equal {equal}, "
                            f"on the host {on_host}, peak {peak} of budget "
                            f"{budget}")
        del g, want, out
    # per case: one streamed block beside the host link and the in-core
    # alternative (the grid up, the in-core block, the grid down)
    for r, (label, spec, shape, budget), host in zip(fresults, fcases,
                                                     hosts):
        with forced_budget(budget):
            plan = CasperEngine(spec, backend="cuda",
                                sweeps=4).plan_for(shape, torch.float64)
            traffic = kstream.host_device_traffic(plan, 4)
            blocks = kstream._block_plans(plan, 4)
            block_ms = wall_ms(
                lambda: kstream.run_plan_streamed(plan, host, 4), 3)
            issue_ms = kstream.LAST_RUN["issue_ms"]
        in_plan = CasperEngine(spec, backend="cuda",
                               sweeps=4).plan_for(shape, torch.float64)
        back = torch.empty_like(host, pin_memory=True)
        incore_ms = wall_ms(lambda: back.copy_(tplan.execute(
            in_plan, host.to("cuda", non_blocking=True))), 3)
        del back
        torch.cuda.empty_cache()
        dev_ms = 0.0
        for p in blocks:
            ops = (math.prod(shape) * p.sweeps
                   * p.spec.structured_flops_per_point())
            dev_ms += max(2 * r["grid_bytes"] / hbm_bw,
                          ops / (peak_f64 / 2)) * 1e3
        h2d_ms = traffic["slab_h2d_bytes"] / link["h2d_Bps"] * 1e3
        d2h_ms = traffic["slab_d2h_bytes"] / link["d2h_Bps"] * 1e3
        # the same with both directions at their rate when run together
        both_ms = max(traffic["slab_h2d_bytes"], traffic["slab_d2h_bytes"]) \
            / link["both_each_Bps"] * 1e3
        r.update(block_ms=block_ms, h2d_bytes=traffic["slab_h2d_bytes"],
                 d2h_bytes=traffic["slab_d2h_bytes"],
                 h2d_GBps=traffic["slab_h2d_bytes"] / block_ms / 1e6,
                 d2h_GBps=traffic["slab_d2h_bytes"] / block_ms / 1e6,
                 link_bound_ms=max(h2d_ms, d2h_ms, dev_ms),
                 link_bound_by=max((h2d_ms, "H2D"), (d2h_ms, "D2H"),
                                   (dev_ms, "device"))[1],
                 device_bound_ms=dev_ms, in_core_ms=incore_ms,
                 link_bound_both_ms=max(both_ms, dev_ms), issue_ms=issue_ms)
        log(f"  2f {label:30s} {str(tuple(shape)):18s} grid "
            f"{r['grid_bytes'] / 2**20:.0f} MiB, budget "
            f"{budget / 2**20:.1f} MiB: {r['slabs']} slabs of "
            f"{r['slab_len']}, overlap {r['overlap']}, peak device "
            f"{r['peak_device_bytes'] / 2**20:.1f} MiB | block "
            f"{block_ms:.2f} ms (H2D {r['h2d_bytes'] / 2**20:.0f} MiB at "
            f"{r['h2d_GBps']:.2f} GB/s, D2H {r['d2h_bytes'] / 2**20:.0f} MiB"
            f" at {r['d2h_GBps']:.2f} GB/s) | link bound "
            f"{r['link_bound_ms']:.2f} ms ({r['link_bound_by']}; device "
            f"{dev_ms:.3f}; at the both-at-once rate {both_ms:.2f}), host "
            f"issue {issue_ms:.2f} ms | in core (up, block, down) {incore_ms:.2f} ms | "
            f"run(iters=10) {r['run_ms']:.1f} ms, pinning "
            f"{r['staging']['pin_ms']:.1f} ms, staging "
            f"{r['staging']['stage_ms']:.1f} ms | card {smi}")
    # one traced block: an H2D copy must overlap a K2 launch and a D2H copy
    from torch.profiler import ProfilerActivity, profile
    t_label, t_spec, t_shape, t_budget = fcases[1]
    with forced_budget(t_budget):
        t_plan = tplan.lower(t_spec, t_shape, torch.float64, backend="cuda",
                             sweeps=4)
    t_traffic = kstream.host_device_traffic(t_plan)
    kstream.execute_plan(t_plan, hosts[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kstream.execute_plan(t_plan, hosts[1])
        torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    events = trace_events(prof, os.path.join(ROOT, "build",
                                             "slab_trace.json"))
    h2d = spans(events, lambda e: e.get("cat") == "gpu_memcpy"
                and "HtoD" in e.get("name", ""))
    d2h = spans(events, lambda e: e.get("cat") == "gpu_memcpy"
                and "DtoH" in e.get("name", ""))
    k2 = spans(events, lambda e: e.get("cat") == "kernel"
               and "casper_" in e.get("name", ""))
    both = [h for h in h2d if any(meet(h, k) for k in k2)
            and any(meet(h, d) for d in d2h)]
    device = spans(events, is_device)
    span = (max(b for _, b in device) - min(a for a, _ in device)
            if device else 0.0)
    trace_info = {"case": t_label, "h2d_copies": len(h2d),
                  "d2h_copies": len(d2h), "k2_launches": len(k2),
                  "h2d_overlapping_k2_and_d2h": len(both),
                  "k2_overlapping_h2d": sum(any(meet(k, h) for h in h2d)
                                            for k in k2),
                  "k2_overlapping_d2h": sum(any(meet(k, d) for d in d2h)
                                            for k in k2),
                  "span_ms": span / 1e3,
                  "h2d_busy_ms": busy(h2d) / 1e3,
                  "d2h_busy_ms": busy(d2h) / 1e3,
                  "kernel_busy_ms": busy(k2) / 1e3,
                  "h2d_bytes": t_traffic["slab_h2d_bytes"],
                  "h2d_GBps_while_busy": t_traffic["slab_h2d_bytes"]
                  / max(busy(h2d), 1e-9) / 1e3}
    log(f"phase 2f: trace of one streamed block ({t_label} {t_shape}, "
        f"{len(t_plan.slabs)} slabs): {trace_info}")
    if not both:
        failures.append(f"phase 2f: the trace shows no H2D copy overlapping "
                        f"a K2 launch and a D2H copy: {trace_info}")
    del hosts
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()
    torch.cuda.empty_cache()
    log(f"phase 2f: {time.time() - t0:.1f}s")

    # ---- phase 2g: backend="vm", the software SPU, on the card ----------
    t0 = time.time()
    vcases = [(n, s, DOMAIN_SIZES["L2"][s.ndim])
              for n, s in PAPER_STENCILS.items()]
    vcases += [(n, p, DOMAIN_SIZES["L2"][p.ndim])
               for n, p in PAPER_PIPELINES.items()]
    vresults = []
    vm_err = 0.0
    for (n, spec0, shape), boundary in itertools.product(vcases,
                                                         BOUNDARIES):
        spec = spec0.with_boundary(boundary)
        g = randn(shape, torch.float64, gen)
        out = CasperEngine(spec, backend="vm", sweeps=4).run(g, iters=6)
        card_plan = tplan.lower(spec, shape, torch.float64, backend="vm",
                                sweeps=4)
        cpu_plan = tplan.lower(spec, shape, torch.float64, backend="vm",
                               sweeps=4, device="cpu")
        _, card_count = tvm.execute_plan(card_plan, g, 6)
        cpu_out, cpu_count = tvm.execute_plan(cpu_plan, g.cpu(), 6)
        want = CasperEngine(spec, backend="ref", sweeps=4).run(g, iters=6)
        err = (out - want).abs().max().item()
        vm_err = max(vm_err, err)
        equal = torch.equal(out.cpu(), cpu_out)
        same = card_count.as_dict() == cpu_count.as_dict()
        vresults.append({"spec": n, "boundary": boundary,
                         "shape": list(shape), "on": str(out.device),
                         "bitwise_equal_cpu_vm": equal,
                         "counters_equal": same,
                         "max_abs_err_ref": err,
                         "counters": card_count.as_dict()})
        if not (equal and same and err <= 1e-12
                and out.device.type == "cuda"):
            failures.append(f"phase 2g {n} {boundary} {shape}: bitwise "
                            f"{equal}, counters {same}, |vm - ref| {err}")
    log(f"phase 2g: backend='vm' on the card, {len(vresults)} cases (each "
        f"paper stencil and pipeline at its Table 3 L2 shape x "
        f"{len(BOUNDARIES)} boundaries, iters=6): "
        f"{sum(r['bitwise_equal_cpu_vm'] for r in vresults)} bitwise equal "
        f"to the VM on the CPU, "
        f"{sum(r['counters_equal'] for r in vresults)} with equal counters, "
        f"max |vm - ref| {vm_err:.3g} (atol 1e-12) in "
        f"{time.time() - t0:.1f}s")
    speed, energy = tpm.speedup_table(), tpm.energy_table()
    paper_model = {}
    for n in speed:
        for level in ("L2", "L3", "DRAM"):
            paper_model[f"{n} {level}"] = {
                "speedup_model": speed[n][level],
                "speedup_paper": tpm.paper_speedup(n, level),
                "energy_model": energy[n][level],
                "energy_paper": tpm.paper_energy_ratio(n, level)}
    log("phase 2g: model of the paper's machines (Table 2 CPU vs Casper; "
        "not card numbers): speedup model/paper, energy model/paper: "
        + "; ".join(f"{k} {v['speedup_model']:.2f}/{v['speedup_paper']:.2f},"
                    f" {v['energy_model']:.2f}/{v['energy_paper']:.2f}"
                    for k, v in paper_model.items()))
    if failures:
        raise SystemExit("phase 2f/2g failed:\n" + "\n".join(failures))

    # ---- phase 2h: serving on the card ------------------------------------
    serve = serving_phase(failures, smi)
    if failures:
        raise SystemExit("phase 2h failed:\n" + "\n".join(failures))

    # ---- phase 2i: the distributed path, eight ranks on the card --------
    torch.cuda.empty_cache()
    distributed = distributed_phase(failures, smi, gen)
    if failures:
        raise SystemExit("phase 2i failed:\n" + "\n".join(failures[:40]))

    # ---- phase 2c: sliding-window attention at gemma2-27b's width --------
    cfg = GEMMA2_LOCAL
    swa_kw = {"window": cfg["window"], "tq": cfg["tq"],
              "softcap": cfg["softcap"]}

    def swa_ref_by_heads(q, k, v, step=4):
        """The dense oracle, ``step`` KV heads (their query heads with
        them) at a time, to bound the S x S score block."""
        g = q.shape[1] // k.shape[1]
        return torch.cat([kswa.swa_ref(
            q[:, h * g:(h + step) * g], k[:, h:h + step], v[:, h:h + step],
            cfg["window"], cfg["softcap"])
            for h in range(0, k.shape[1], step)], dim=1)

    swa_runs = [(s, torch.bfloat16) for s in GEMMA2_SEQS]
    swa_runs += [(GEMMA2_SEQS[0], torch.float32),
                 (GEMMA2_SEQS[0], torch.float16)]
    swa_in = [tuple(randn((cfg["batch"], h, s, cfg["head_dim"]), dtype, gen)
                    for h in (cfg["hq"], cfg["hkv"], cfg["hkv"]))
              for s, dtype in swa_runs]
    torch.cuda.synchronize()
    t0 = time.time()
    keng.reset_launches()
    swa_out, swa_per_run = [], []
    for q, k, v in swa_in:
        before = dict(keng.LAUNCHES)
        swa_out.append(kops.swa(q, k, v, **swa_kw))
        swa_per_run.append({n: keng.LAUNCHES[n] - before[n]
                            for n in keng.LAUNCHES
                            if keng.LAUNCHES[n] != before[n]})
    torch.cuda.synchronize()
    alaunches = dict(keng.LAUNCHES)
    log(f"phase 2c: ops.swa at gemma2-27b's local layer {cfg} on "
        f"{[(s, str(dt)) for s, dt in swa_runs]} in {time.time() - t0:.2f}s;"
        f" launches {alaunches}")
    swa_results = []
    for (s, dtype), (q, k, v), out, k_run in zip(swa_runs, swa_in, swa_out,
                                                 swa_per_run):
        label = f"phase 2c S={s} {dtype}"
        if k_run != {"K5": 1}:
            failures.append(f"{label}: launched {k_run}")
        plain_err = compare("K5", out, kswa.sliding_window_attention_plain(
            q, k, v, **swa_kw), dtype, label)
        if dtype == torch.bfloat16:
            swa_cross_check(out, q, k, v, cfg["window"], cfg["tq"],
                            cfg["softcap"], label)
        ref = swa_ref_by_heads(q.float(), k.float(), v.float())
        ref_err = (out.float() - ref).abs().max().item()
        if dtype == torch.float16:
            # the oracle rounded once to f16, as the plain version is
            limit = f"one f16 ulp or {SWA_BF16_FLOOR}"
            ref_ok = within_bf16_ulp(out, ref.half(), SWA_BF16_FLOOR,
                                     bits=10)
        else:
            limit = SWA_REF_BF16_ATOL if dtype == torch.bfloat16 \
                else SWA_F32_ATOL
            ref_ok = ref_err <= limit
        del ref
        finite = bool(torch.isfinite(out).all())
        if not (ref_ok and finite and out.shape == q.shape):
            failures.append(f"{label}: vs swa_ref {ref_err} (limit {limit}),"
                            f" finite {finite}, shape {tuple(out.shape)}")
        swa_results.append({"seq": s, "dtype": str(dtype),
                            "launches_per_run": k_run,
                            "max_abs_err_plain": plain_err,
                            "max_abs_err_swa_ref": ref_err,
                            "swa_ref_limit": limit})
        log(f"  S={s} {dtype}: launches {k_run}, |err| vs plain {plain_err}"
            f", vs swa_ref {ref_err} (limit {limit})")
    del swa_out
    torch.cuda.empty_cache()
    if alaunches["K5"] < 1 or failures:
        raise SystemExit("phase 2c failed:\n" + "\n".join(failures))

    # ---- phase 3: times ---------------------------------------------------
    def op_bound_ms(spec, shape, sweeps=4):
        """Operations over the f64 rate without FMA (half the data
        sheet's, which counts an FMA as two): the arithmetic the f64
        contract fixes per point and application, a product and an add
        per tap (per factor tap, plus the term sums, for a separable
        spec's factored order; summed over a pipeline's stages)."""
        per_point = sweeps * spec.structured_flops_per_point()
        ops = math.prod(shape) * per_point
        return ops / (peak_f64 / 2) * 1e3, per_point

    log("phase 3: one fused block (sweeps=4) per case, median of CUDA "
        f"events | card {smi}")
    log(f"  {'stencil':20s} {'shape':16s} {'kern':6s} {'ms':>8s} "
        f"{'GB/s':>7s} {'bound':>7s} {'by':4s} {'plain':>8s} {'conv':>8s} "
        f"{'staged':>8s}")
    for r, c, g, plan in (list(zip(results, cases, grids, plans))
                          + list(zip(presults, pcases, pgrids, pplans))
                          + list(zip(sresults, scases, sgrids, splans))):
        n, spec, shape, level = c[:4]
        kernel = kernel_of(plan)
        reps = 20 if level == "HBM" else 50
        ms = time_ms(lambda: tplan.execute(plan, g), reps)
        # a batch of grids (serving): per-grid traffic times the batch
        gshape = tuple(shape[len(shape) - spec.ndim:])
        batch = math.prod(shape) // math.prod(gshape)
        if is_pipe(spec):
            traffic = keng.hbm_pipeline_traffic(spec, gshape, plan.tile, 4, 8)
        else:
            traffic = keng.hbm_traffic(spec, gshape, plan.tile, 4, 8)
        traffic = {k: v * batch for k, v in traffic.items()}
        pad_ms = other_ms = None
        if level == "serving":
            # the host pad of a padded-window block, and the same block on
            # the other entry (K1/K3 pad-free, or the pad and K2/K4)
            wide = tuple(4 * h for h in spec.halo)
            pad_ms = time_ms(lambda: tref.pad_boundary(
                g, wide, spec.boundary_mode, spec.boundary_value), reps)
            other = ("pad-free" if plan.ghost_strategy == "padded-window"
                     else "padded-window")
            oplan = dataclasses.replace(plan, ghost_strategy=other)
            other_ms = time_ms(lambda: tplan.execute(oplan, g), reps)
            compare(kernel_of(oplan), tplan.execute(oplan, g),
                    tplan.execute(plan, g), torch.float64,
                    f"phase 3 {n} {shape} {other}")
        bytes_ms = 2 * math.prod(shape) * 8 / hbm_bw * 1e3
        ops_ms, ops_pt = op_bound_ms(spec, shape)
        bound = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        lib = time_ms(lambda: conv_chain(spec, 4)(g),
                      5 if level == "HBM" else 10)
        staged_ms = None
        if kernel == "staged":
            def plain():
                out = g
                for _ in range(4):
                    for st in spec.stages:
                        out = keng.stencil_sweep_plain(
                            st, out, tplan.default_tile(st, 1, 8), 1)
                return out
        else:
            plain = plain_block(spec, g, plan.tile, 4, plan.ghost_strategy)
            compare(kernel, tplan.execute(plan, g), plain(), torch.float64,
                    f"phase 3 {n} {shape}")
        if is_pipe(spec):
            def staged():
                out = g
                for _ in range(4):
                    for st in spec.stages:
                        out = keng.stencil_sweep(st, out, sweeps=1,
                                                 strategy="pad-free")
                return out
            staged_ms = time_ms(staged, reps)
        torch.cuda.empty_cache()
        plain_ms = time_ms(plain, 3, warmup=1)
        torch.cuda.empty_cache()
        r.update(kernel=kernel, tile=None if plan.tile is None
                 else list(plan.tile), ms=ms,
                 gbps=traffic["fused_bytes"] / ms / 1e6,
                 fused_bytes=traffic["fused_bytes"], bound_ms=bound,
                 bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
                 ops_per_point=ops_pt, plain_ms=plain_ms,
                 library_ms=lib, staged_ms=staged_ms, pad_ms=pad_ms,
                 other_entry_ms=other_ms)
        log(f"  {n + ' ' + r['boundary'][:9]:20s} {str(tuple(shape)):16s} "
            f"{kernel:6s} {ms:8.4f} {r['gbps']:7.1f} {bound:7.4f} "
            f"{bound_by[:4]:4s} {plain_ms:8.2f} {lib:8.3f} "
            f"{'' if staged_ms is None else f'{staged_ms:8.4f}'}"
            + ("" if pad_ms is None else f" | host pad {pad_ms:.4f}, other "
               f"entry ({'K1/K3' if plan.ghost_strategy != 'pad-free' else 'pad + K2/K4'}) {other_ms:.4f}"))
    if failures:
        raise SystemExit("phase 3 failed:\n" + "\n".join(failures))
    serving = serving_times(smi)

    # ---- phase 3, tile="auto": the tuned tile against the default and
    # the measured candidates, all timed in turn (kernels.tune.measure_tiles)
    x = torch.empty(2 ** 27, dtype=torch.float64, device="cuda")
    y = torch.empty_like(x)
    x.fill_(1.0)
    y.copy_(x)
    copy_s = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y.copy_(x)
        end.record()
        end.synchronize()
        copy_s.append(start.elapsed_time(end) / 1e3)
    copy_bw = 2 * x.numel() * 8 / min(copy_s)
    del x, y
    torch.cuda.empty_cache()
    log(f"phase 3 tuning: copy bandwidth {copy_bw:.4g} B/s (1 GiB read + 1 "
        f"GiB written, best of 10) | card {smi}")
    tune_cache = os.path.join(ROOT, "build", "tune_cache")
    shutil.rmtree(tune_cache, ignore_errors=True)
    os.environ[ktune.TUNE_CACHE_ENV] = tune_cache
    ktune.TUNE_DISK_CACHE.reset()
    tuning = []
    for key, cs, res, gs, dplans in (("a", cases, results, grids, plans),
                                     ("b", pcases, presults, pgrids, pplans),
                                     ("d", scases, sresults, sgrids, splans)):
        for c, r, g, dplan, aplan in zip(cs, res, gs, dplans,
                                         auto_runs[key][1]):
            spec, shape = c[1], tuple(c[2])
            forced = c[4] if len(c) > 4 else None
            gshape = shape[len(shape) - spec.ndim:]
            batch = math.prod(shape) // math.prod(gshape)
            default = dplan.tile
            row = {"case": f"2{key} {c[0]} {r['boundary']} {list(shape)}"
                           + (f" forced {forced}" if forced else ""),
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
            if not aplan.fused:
                # a staged chain: its stage plans' tiles, auto vs default
                ms_auto = time_ms(lambda: tplan.execute(aplan, g), 25)
                ms_def = time_ms(lambda: tplan.execute(dplan, g), 25)
                row.update(auto_ms=ms_auto, default_ms=ms_def,
                           stage_tiles_auto=[list(aplan.stage_plan(k).tile)
                                             for k in range(len(spec.stages))],
                           stage_tiles_default=[
                               list(dplan.stage_plan(k).tile)
                               for k in range(len(spec.stages))])
                log(f"  tune {row['case']} (staged): auto {ms_auto:.4f} ms "
                    f"(stages {row['stage_tiles_auto']}), default "
                    f"{ms_def:.4f} ({row['stage_tiles_default']}) | bound "
                    f"{r['bound_ms']:.4f}")
                tuning.append(row)
                continue
            auto = aplan.tile
            tuner = (ktune.autotune_pipeline if is_pipe(spec)
                     else ktune.autotune)
            analytic = tuner(spec, gshape, 4, 8)
            top3 = [t for t, cst in analytic.table if math.isfinite(cst)][:3]
            tiles = list(dict.fromkeys(
                [auto] + (top3 if key != "d" else []) + [default]))
            timed = dict(ktune.measure_tiles(spec, g, tiles, 4, TUNE_ROUNDS,
                                             forced))
            best = min(timed, key=timed.get)
            ratio = timed[auto] / timed[best]
            row.update(default=list(default), auto=list(auto),
                       default_ms=timed[default] * 1e3,
                       auto_ms=timed[auto] * 1e3, best=list(best),
                       best_ms=timed[best] * 1e3, auto_over_best=ratio,
                       measured={str(t): v * 1e3 for t, v in timed.items()},
                       analytic_ms={str(t): cst * 1e3
                                    for t, cst in analytic.table[:3]})
            if key != "d":
                # the fitted constants, and the analytic top under them
                cal = ktune.fit_calibration(copy_bw, [
                    {"n_ctas": tplan.launch_blocks(gshape, t, batch),
                     "seconds": v} for t, v in timed.items()])
                os.environ[tplan._pm.CALIBRATION_ENV] = json.dumps(cal)
                try:
                    cal_top = tuner(spec, gshape, 4, 8).tile
                finally:
                    del os.environ[tplan._pm.CALIBRATION_ENV]
                if cal_top not in timed:
                    pair = dict(ktune.measure_tiles(spec, g, [cal_top, auto],
                                                    4, TUNE_ROUNDS, forced))
                    cal_ms = pair[cal_top] / pair[auto] * timed[auto] * 1e3
                else:
                    cal_ms = timed[cal_top] * 1e3
                row.update(fitted=cal, calibrated_top=list(cal_top),
                           calibrated_top_ms=cal_ms,
                           calibrated_over_best=cal_ms / (timed[best] * 1e3))
                if not forced:
                    # the measured tuner itself, and its disk cache
                    m = ktune.autotune_measured(spec, g, 4, top_k=3,
                                                reps=TUNE_ROUNDS)
                    again = ktune.autotune_measured(spec, g, 4, top_k=3,
                                                    reps=TUNE_ROUNDS)
                    if again.table != m.table:
                        failures.append(f"{row['case']}: CASPER_TUNE_CACHE "
                                        "did not serve the stored tune")
                    row["autotune_measured"] = m.as_dict()
                if ratio > AUTO_LIMIT:
                    failures.append(f"phase 3 {row['case']}: auto {auto} "
                                    f"{timed[auto] * 1e3:.4f} ms is "
                                    f"{ratio:.2f}x the best measured "
                                    f"{best} {timed[best] * 1e3:.4f}")
            log(f"  tune {row['case']}: default {default} "
                f"{timed[default] * 1e3:.4f} ms, auto {auto} "
                f"{timed[auto] * 1e3:.4f} ms, best {best} "
                f"{timed[best] * 1e3:.4f} ms (auto/best {ratio:.3f})"
                + (f" | top-3 {top3}, fitted {cal}, calibrated top "
                   f"{cal_top} {cal_ms:.4f} ms"
                   + (f", autotune_measured {m.tile}" if not forced else "")
                   if key != "d" else "")
                + f" | bound {r['bound_ms']:.4f} | card {smi}")
            tuning.append(row)
    worst = max(t.get("auto_over_best", 0) for t in tuning
                if t["case"][:2] in ("2a", "2b"))
    log(f"phase 3 tuning: CASPER_TUNE_CACHE {ktune.TUNE_DISK_CACHE.as_dict()}"
        f"; worst auto/best on 2a/2b {worst:.3f} (gate {AUTO_LIMIT})")
    del os.environ[ktune.TUNE_CACHE_ENV]
    n_measured = sum("autotune_measured" in t for t in tuning)
    if ktune.TUNE_DISK_CACHE.as_dict() != {"hits": n_measured,
                                           "misses": n_measured,
                                           "stores": n_measured}:
        failures.append(f"phase 3 tuning: CASPER_TUNE_CACHE counters "
                        f"{ktune.TUNE_DISK_CACHE.as_dict()} for {n_measured} "
                        "measured tunes, each stored once and served once")
    if failures:
        raise SystemExit("phase 3 tuning failed:\n" + "\n".join(failures))

    # ---- the kernels line: one representative main-path case each ------
    def kernel_entry(kname, spec, g, window_call, launches, launches_of):
        """A kernel's entry on ``g`` (one grid, or a leading batch of
        grids: one launch), f64, sweeps=4: the kernel alone (K2/K4 on the
        pre-padded window) beside its bound, plain version and batched
        ``F.conv`` chain."""
        nd = spec.ndim
        shape = tuple(g.shape)
        gshape = shape[len(shape) - nd:]
        sweeps = 4
        tile = tplan.normalize_tile(spec, None, sweeps, 8, gshape)
        wide = tuple(sweeps * h for h in spec.halo)
        if window_call:
            src = tref.pad_boundary(g, wide, spec.boundary_mode,
                                    spec.boundary_value)
            fn = (keng.pipeline_window_sweep if is_pipe(spec)
                  else keng.stencil_window_sweep)
            pfn = (keng.pipeline_window_sweep_plain if is_pipe(spec)
                   else keng.stencil_window_sweep_plain)

            def kern():
                return fn(spec, src, gshape, (0,) * nd, gshape, tile, sweeps)

            def plain():
                return pfn(spec, src, gshape, (0,) * nd, gshape, tile,
                           sweeps)
        else:
            src = g
            fn = keng.pipeline_sweep if is_pipe(spec) else keng.stencil_sweep

            def kern():
                return fn(spec, g, tile, sweeps, "pad-free")

            plain = plain_block(spec, g, tile, sweeps, "pad-free")
        nbytes = (src.numel() + g.numel()) * 8
        t_bytes = nbytes / hbm_bw * 1e3
        t_ops, ops_pt = op_bound_ms(spec, shape, sweeps)
        compare(kname, kern(), plain(), torch.float64, f"kernels {kname}")
        lib = conv_chain(spec, sweeps)
        entry = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches,
            "launches_of": launches_of,
            "max_abs_err": max_err[kname.split(" (")[0]],
            "ms": time_ms(kern, 20),
            "plain_ms": time_ms(plain, 3, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lambda: lib(g), 5),
            "shape": list(shape), "tile": list(tile), "spec": spec.name,
            "boundary": getattr(spec, "boundary", None)
            or "+".join(s.boundary for s in spec.stages),
            "sweeps": sweeps, "dtype": "float64",
            "ops_per_point": ops_pt,
        }
        torch.cuda.empty_cache()
        return entry

    def grid_of(gs, cs, n, boundary, shape):
        return gs[[i for i, c in enumerate(cs)
                   if c[0] == n and tuple(c[2]) == shape and len(c) == 4
                   and getattr(c[1], "boundary_mode", None) == boundary][0]]

    def launches_where(res, cs, kname, pred):
        """Launches of ``kname`` in the main path's run (phase 2a or 2b)
        over the cases ``pred`` keeps."""
        return sum(r["launches_per_run"].get(kname, 0)
                   for r, c in zip(res, cs) if pred(c))

    def flat(c):
        return c[1].ndim < 3

    def named(n):
        return lambda c: c[0] == n

    star_cube = tuple(DOMAIN_SIZES["DRAM"][3])
    kernels = [
        kernel_entry("K1", PAPER_STENCILS["jacobi2d"],
                     grid_of(grids, cases, "jacobi2d", "zero", (8192, 8192)),
                     False, launches_where(results, cases, "K1", flat),
                     "phase 2a, 1-D and 2-D specs"),
        kernel_entry("K2", PAPER_STENCILS["jacobi2d"].with_boundary(
            "periodic"), grid_of(grids, cases, "jacobi2d", "periodic",
                                 (2048, 2048)), True,
            launches_where(results, cases, "K2", flat),
            "phase 2a, 1-D and 2-D specs"),
        kernel_entry("K1 rank 3", PAPER_STENCILS["star33_3d"],
                     grid_of(grids, cases, "star33_3d", "zero", star_cube),
                     False, launches_where(results, cases, "K1",
                                           named("star33_3d")),
                     "phase 2a, star33_3d"),
        kernel_entry("K1 rank 3 (heat3d)", PAPER_STENCILS["heat3d"],
                     grid_of(grids, cases, "heat3d", "zero", (512, 512, 256)),
                     False, launches_where(results, cases, "K1",
                                           named("heat3d")),
                     "phase 2a, heat3d"),
        kernel_entry("K2 rank 3", PAPER_STENCILS["star33_3d"].with_boundary(
            "periodic"), grid_of(grids, cases, "star33_3d", "periodic",
                                 star_cube), True,
            launches_where(results, cases, "K2", lambda c: not flat(c)),
            "phase 2a, 3-D specs"),
        kernel_entry("K3", rd, grid_of(pgrids, pcases, "reaction_diffusion2d",
                                       "reflect", (8192, 8192)),
                     False, plaunches["K3"], "phase 2b"),
        kernel_entry("K4", ad, grid_of(pgrids, pcases, "advect_diffuse2d",
                                       "periodic", (2048, 2048)),
                     True, plaunches["K4"], "phase 2b"),
    ]
    # K2 and K4 (1-D/2-D) carry the serving rows: the padded-window
    # kernel alone on each batch's pre-padded windows, with the launches
    # the row's main path (phase 2d) made of it
    for e in kernels:
        if e["name"] not in ("K2", "K4"):
            continue
        e["rows"] = [
            kernel_entry(e["name"], c[1], g, True,
                         r["launches_per_run"].get(e["name"], 0), "phase 2d")
            for r, c, g in zip(sresults, scases, sgrids)
            if c[1].ndim < 3 and is_pipe(c[1]) == (e["name"] == "K4")]
        e["launches"] += sum(row["launches"] for row in e["rows"])
        e["launches_of"] += " and 2d (serving)"
        for row in e["rows"]:
            log(f"  kernels line {e['name']} row {row['spec']:20s} "
                f"{str(tuple(row['shape'])):18s} tile {row['tile']} "
                f"{row['ms']:8.4f} ms | bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}) | plain {row['plain_ms']:.2f} | "
                f"library {row['library_ms']:.3f} | launches "
                f"{row['launches']}")
    # the slab executor's launches (phase 2f): K2 of 1-D/2-D specs and of
    # stage slabs, K2 rank 3 (heat3d, star33_3d), K4 (rd)
    for e in kernels:
        n2f = sum(r["launches_per_run"].get(
            "K4" if e["name"] == "K4" else "K2", 0) for r in fresults
            if (len(r["shape"]) == 3) == (e["name"] == "K2 rank 3"))
        if e["name"] in ("K2", "K2 rank 3", "K4"):
            e["launches"] += n2f
            e["launches_of"] += " and 2f (slabs)"
    # the other entries' launches in the serving path
    for e in kernels:
        kname, pred = {"K1": ("K1", flat), "K3": ("K3", flat),
                       "K1 rank 3 (heat3d)": ("K1", named("heat3d")),
                       "K2 rank 3": ("K2", lambda c: not flat(c))}.get(
                           e["name"], (None, None))
        if kname is not None:
            e["launches"] += launches_where(sresults, scases, kname, pred)
            e["launches_of"] += " and 2d (serving)"
    # phase 2h's launches (serving on the card), by kernel and rank
    for (kname, rank3), n in serve["launches"].items():
        entry = {("K1", False): "K1", ("K2", False): "K2",
                 ("K1", True): "K1 rank 3 (heat3d)",
                 ("K2", True): "K2 rank 3", ("K3", False): "K3",
                 ("K4", False): "K4"}[(kname, rank3)]
        e = next(e for e in kernels if e["name"] == entry)
        e["launches"] += n
        if "2h" not in e["launches_of"]:
            e["launches_of"] += " and 2h (servers)"
    # phase 2i's launches: every rank's K2/K4 on its shard windows
    for name, n in distributed["launches"].items():
        e = next(e for e in kernels if e["name"] == name)
        e["launches"] += n
        e["launches_of"] += " and 2i (8 ranks, shard windows)"
    for e in kernels:
        log(f"  kernels line {e['name']:18s} {e['spec']:20s} "
            f"{str(tuple(e['shape'])):16s} {e['ms']:8.4f} ms | bound "
            f"{e['bound_ms']:.4f} ({e['bound_by']}, {e['ops_per_point']} "
            f"ops/pt) | plain {e['plain_ms']:.2f} | library "
            f"{e['library_ms']:.3f} | launches {e['launches']} "
            f"({e['launches_of']})")

    def swa_dtype_entry(kname, q, k, v, count):
        """K5 in f16 (wgmma) or f32 (three TF32 passes) at the phase-2c
        shape beside its bound, its plain version and SDPA in the same
        dtype with the same band mask (f32: TF32 off).  The bound is the
        useful FLOP at the dense f16 tensor rate, or three TF32 passes of
        it at the dense TF32 rate for f32 (the least time this card forms
        f32-accurate products in), or the bytes if larger; f32 keeps the
        bound of its earlier CUDA-core kernel (f32 FLOP outside the
        tensor cores) under ``bound_f32_cuda_cores_ms``."""
        b, hq, s, d = q.shape
        w, tq, softcap = cfg["window"], cfg["tq"], cfg["softcap"]
        keys = sum(min(p + 1, w) for p in range(s))
        flop = 4 * b * hq * d * keys
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_bytes = nbytes / hbm_bw * 1e3
        f32 = q.dtype == torch.float32
        t_ops = (3 * flop / peak_tf32_tc if f32 else flop / peak_f16_tc) * 1e3
        g = hq // k.shape[1]
        kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        pos = torch.arange(s, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - w)

        def sdpa():
            return F.scaled_dot_product_attention(q, kk, vv, attn_mask=band)

        def kern(cap=softcap):
            return kswa.sliding_window_attention(q, k, v, w, tq, cap)
        lib_diff = (sdpa().float() - kern(None).float()).abs().max().item()
        entry = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": count,
            "max_abs_err": swa_err[q.dtype],
            "ms": time_ms(kern, 10),
            "plain_ms": time_ms(lambda: kswa.sliding_window_attention_plain(
                q, k, v, w, tq, softcap), 3, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(sdpa, 10),
            "shape": {"q": list(q.shape), "kv": list(k.shape)},
            "dtype": str(q.dtype).replace("torch.", ""),
            "window": w, "tq": tq, "softcap": softcap,
            "ms_no_softcap": time_ms(lambda: kern(None), 10),
            "flop": flop, "bytes_ms": t_bytes,
            "library": "F.scaled_dot_product_attention, bool band mask, "
                       "softcap=None" + (", TF32 off" if f32 else ""),
            "library_max_abs_diff_no_softcap": lib_diff,
        }
        if f32:
            entry["bound_f32_cuda_cores_ms"] = flop / peak_f32 * 1e3
        log(f"  {kname} {entry['shape']}: {entry['ms']:.3f} ms (softcap off "
            f"{entry['ms_no_softcap']:.3f}) | bound {t_ops:.3f} ms ("
            + ("three TF32 passes at the dense TF32 rate; f32 FLOP outside "
               f"the tensor cores {entry['bound_f32_cuda_cores_ms']:.3f}"
               if f32 else "useful FLOP at the dense f16 tensor rate")
            + f") | plain {entry['plain_ms']:.2f} ms | SDPA "
            f"{entry['library_ms']:.3f} ms (max |diff| vs K5 {lib_diff:.3g})"
            f" | card {smi}")
        del kk, vv, band
        torch.cuda.empty_cache()
        return entry

    def swa_entry(q, k, v, count, f32_in):
        """K5 bf16 at the phase-2c shape: times beside the operation
        bounds, the plain version and SDPA with the same band mask; the
        f32 K5 on ``f32_in`` (same width) is timed for the log."""
        b, hq, s, d = q.shape
        w, tq, softcap = cfg["window"], cfg["tq"], cfg["softcap"]
        # useful work: every query against its min(p+1, W) valid keys,
        # two products of 2*D FLOP each per (query head, key)
        keys = sum(min(p + 1, w) for p in range(s))
        flop = 4 * b * hq * d * keys
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_bytes = nbytes / hbm_bw * 1e3
        t_f32 = flop / peak_f32 * 1e3
        t_tc = flop / peak_bf16_tc * 1e3

        def kern(cap=softcap):
            return kswa.sliding_window_attention(q, k, v, w, tq, cap)

        g = hq // k.shape[1]
        kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        pos = torch.arange(s, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - w)

        def sdpa():
            return F.scaled_dot_product_attention(q, kk, vv, attn_mask=band)

        lib_diff = (sdpa().float() - kern(None).float()).abs().max().item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kswa.sliding_window_attention_plain(q, k, v, w, tq, softcap)
        plain_peak = torch.cuda.max_memory_allocated() - base
        entry = {
            "name": "K5", "route": "cuda", "source": SOURCES["K5"],
            "replaces": REPLACES["K5"], "launches": count["K5"],
            "max_abs_err": swa_err[torch.bfloat16],
            "ms": time_ms(kern, 20),
            "plain_ms": time_ms(lambda: kswa.sliding_window_attention_plain(
                q, k, v, w, tq, softcap), 3, warmup=1),
            "bound_ms": max(t_bytes, t_tc),
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "library_ms": time_ms(sdpa, 10),
            "shape": {"q": list(q.shape), "kv": list(k.shape)},
            "dtype": str(q.dtype).replace("torch.", ""),
            "window": w, "tq": tq, "softcap": softcap,
            "ms_no_softcap": time_ms(lambda: kern(None), 20),
        }
        f32_ms = time_ms(lambda: kswa.sliding_window_attention(
            *f32_in, w, tq, softcap), 5)
        # what the bf16 kernel runs on the tensor cores: every chunk of
        # every block, all TC_ROWS rows, Q.K^T once and P.V per bf16 term
        npos, kc = kswa.tc_positions(g), kswa.tc_chunk_keys(d)
        chunks = sum(-(-(min(s - 1, p0 + npos - 1) - max(0, p0 - w + 1) + 1)
                       // kc) for p0 in range(0, s, npos))
        tc_flop = (chunks * kc * kswa.TC_ROWS * d * 2 * (1 + kswa.TC_TERMS)
                   * b * k.shape[1])
        details = {
            "tc_budget": tc_budget,
            "useful_tflops": flop / entry["ms"] / 1e9,
            "tensor_flop_executed": tc_flop,
            "executed_tflops": tc_flop / entry["ms"] / 1e9,
            "executed_tflops_no_softcap": tc_flop / entry["ms_no_softcap"]
            / 1e9,
            "useful_tflops_no_softcap": flop / entry["ms_no_softcap"] / 1e9,
            "f32_ms": f32_ms,
            "cross_check_max_abs_diff": cross_err[0],
            "flop": flop, "bytes": nbytes, "bytes_ms": t_bytes,
            "bound_f32_cuda_cores_ms": t_f32, "bound_bf16_tensor_ms": t_tc,
            "library": "F.scaled_dot_product_attention, bool band mask, "
                       "K/V repeat_interleave'd outside the timing, "
                       "softcap=None",
            "library_max_abs_diff_no_softcap": lib_diff,
            "plain_peak_bytes": plain_peak,
            "max_abs_err_f32": swa_err[torch.float32],
            "max_abs_err_bf16": swa_err[torch.bfloat16],
        }
        log(f"  K5 {entry['shape']} {entry['dtype']}: {entry['ms']:.3f} ms "
            f"(softcap off {entry['ms_no_softcap']:.3f}) | bounds: "
            f"{flop:.4g} FLOP at f32 {t_f32:.3f} ms, at bf16 tensor "
            f"{t_tc:.3f} ms; {nbytes} B at {t_bytes:.4f} ms | plain "
            f"{entry['plain_ms']:.2f} ms (peak {plain_peak / 2**30:.2f} GiB) | SDPA {entry['library_ms']:.3f} ms"
            f" (max |diff| vs K5 {lib_diff:.3g}) | card {smi}")
        log(f"  K5 bf16 (tensor cores) useful rate "
            f"{details['useful_tflops']:.1f} TFLOP/s (softcap off "
            f"{details['useful_tflops_no_softcap']:.1f}) of "
            f"{peak_bf16_tc / 1e12:.0f}; executed on the tensor cores "
            f"{tc_flop:.4g} FLOP, {details['executed_tflops']:.1f} TFLOP/s "
            f"(softcap off {details['executed_tflops_no_softcap']:.1f}); "
            f"f32 K5 (three TF32 passes) at the same "
            f"width {f32_ms:.3f} ms | card {smi}")
        del kk, vv, band
        torch.cuda.empty_cache()
        return entry, details

    by_dtype = {dt: sum(k.get("K5", 0) for (_, d), k in zip(swa_runs,
                                                            swa_per_run)
                        if d == dt)
                for dt in (torch.bfloat16, torch.float32, torch.float16)}
    k5_entry, k5_details = swa_entry(*swa_in[0], {
        "K5": by_dtype[torch.bfloat16]}, swa_in[2])
    kernels.append(k5_entry)
    kernels.append(swa_dtype_entry("K5 f16", *swa_in[3],
                                   by_dtype[torch.float16]))
    kernels.append(swa_dtype_entry("K5 f32", *swa_in[2],
                                   by_dtype[torch.float32]))
    if failures:
        raise SystemExit("kernels line failed:\n" + "\n".join(failures))

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "rates_of": rate_key,
                   "hbm_bw": hbm_bw, "peak_f64": peak_f64,
                   "phase1_cases": n_cases, "phase1_tiles": tiles,
                   "phase1_window_ctas": window_ctas,
                   "chain_ptxas": chain_budget, "launches": launches,
                   "pipeline_launches": plaunches, "cases": results,
                   "pipeline_cases": presults, "serving_launches": slaunches,
                   "serving_cases": sresults, "swa_phase1_cases": n_swa,
                   "swa_launches": alaunches, "swa_cases": swa_results,
                   "k5_details": k5_details, "kernels": kernels,
                   "copy_bw": copy_bw, "tuning": tuning,
                   "auto_cases": {k: v[2] for k, v in auto_runs.items()},
                   "link": link, "slab_cases": fresults,
                   "slab_launches": flaunches, "slab_trace": trace_info,
                   "slab_repairs": rresults,
                   "vm_cases": vresults, "paper_model": paper_model,
                   "host_ram": mem,
                   "serving": serve | {"launches": named(serve["launches"])},
                   "serving_times": serving, "distributed": distributed,
                   "plans_verified": tanalysis.counters()["verifications"]
                   - verified0,
                   "seconds": time.time() - t_start}, fh, indent=1,
                  default=str)
    log(f"phases 2-3: {tanalysis.counters()['verifications'] - verified0} "
        f"plans verified strictly, no finding")
    log(f"total {time.time() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
