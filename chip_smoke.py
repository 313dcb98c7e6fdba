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
   fails the phase; (j) LM serving (``repro_torch.models``,
   ``serve.ServeEngine``; plain PyTorch, no TPU kernel on this path), one
   model at a time at its published width and depth in bf16, params from
   ``init_params`` under a seeded CUDA generator: (i) qwen3-14b, 4 prompts
   of 256 tokens -> 32 greedy tokens; (iii) gemma2-27b, one prompt of
   4,608 tokens (past the 4,096 window: blockwise prefill over a banded
   KV range) -> 8 decode steps; (iv) zamba2-7b (81 Mamba2 layers in 27
   units, the shared block with its per-unit LoRA firing on 13), 4 x
   1,024 (four SSD chunks each) -> 32; (vi) xlstm-125m (12 blocks, sLSTM
   at 3 and 9), 4 x 1,024 -> 32; (vii) whisper-tiny, 4 clips of 1,500
   frames (the encoder blockwise, non-causal) with 64-token prompts ->
   32.  Each is served on the reference's init (``lm_serve``): tokens
   within the vocabulary, prefill ms and tokens/s and decode ms per step
   (median, synchronized) beside their bounds (``transformer_work``,
   ``zamba_work``, ``xlstm_work``, ``whisper_work``: bf16 and f32 work at
   their rates against the bytes), peak device memory, and one prefill
   and three decode steps under ``torch.profiler`` (device busy and idle
   share, kernels per call, the heaviest kernels).  Then the query and
   key projections are rescaled to their true fan-in (``scale_scores``)
   and the model is checked (``lm_check``): teacher-forced decode logits
   against a prefill over the same tokens (``LM_DECODE_ATOL``), clean and
   with faults planted in
   the last decode step (the cache slot one late and one early; one
   layer's recurrent state one update behind; the cross K/V of the next
   clip), each of which must fail the gate; for zamba2, xLSTM and Whisper
   the same in f32, TF32 off (``LM_F32_DECODE_ATOL``).  Card vs host in
   f32 (``LM_F32_ATOL``, the error on TF32 logged): (ii) one qwen3-14b
   unit, (v) one firing zamba2-7b unit, and xlstm-125m whole; (k) LM
   training (``repro_torch.train``, ``optim``, ``checkpointing``,
   ``data``; plain PyTorch and autograd, no TPU kernel on this path) at
   full width, depth cut to fit the state: (i) qwen3-14b, 4 of 40 layers,
   remat, 4 x 1,024 tokens, AdamW in f32, 10 steps; (ii) olmoe-1b-7b, 4
   of 16 layers, two microbatches, 8-bit AdamW state and int8 gradient
   compression, 10 steps; each timed per step (synchronized, median)
   beside its bound (``train_work``: ``model_flops`` at the bf16 rate
   against the optimizer's state bytes), one step traced, the loss
   falling by ``TRAIN_FALL_GATE`` and, with the update's sign flipped,
   not; (iii) xlstm-125m whole through the ``Trainer``, at its true
   fan-in: checkpoints, an injected failure, a new Trainer resuming, its
   end state bitwise equal to a straight run's (and a run resumed one
   step behind parting), checkpoint save and restore timed, the loss
   falling by ``TRAINER_FALL_GATE`` and, flipped, not; (iv) one qwen3-14b layer with the
   full vocabulary in f32: the step's loss, grads, moments and update on
   the card against the host's (``TRAIN_CHECK_GATES``), clean and with
   the clip not applied, one microbatch dropped and the bias correction
   one step off; (l) the sharded LM paths (``repro_torch.sharding``:
   DTensors on a ``DeviceMesh``), eight ranks on the card over gloo on a
   (2, 4) mesh, each case held against the same run on one device, each
   gate beside a planted fault (see the comment above ``LM2L_GATES``).
   Every plan of phases 2 and 3 is
   lowered under
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
phase-2i ranks' launches; phases 2j, 2k and 2l launch none of them) before
the last line, which is ``{"ok": true, "device": {...}}``.  Full
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


# phase 2j: LM serving (repro_torch.models, serve.ServeEngine): plain
# PyTorch, no TPU kernel on this path (PERF.md, kernel table).  Every
# model at its published width and depth, bf16, params from a seeded CUDA
# generator: (i) qwen3-14b (src/repro/configs/qwen3_14b.py: 40 layers,
# d_model 5120, 40/8 heads of 128, d_ff 17408, vocab 151,936), 4 prompts
# of 256 tokens, 32 greedy tokens; (iii) gemma2-27b (46 layers, 27.2e9
# params, 54.4 GB in bf16: it fits the card once qwen3-14b's params are
# freed), one prompt of 4,608 tokens (past its 4,096 window: prefill is
# blockwise over a banded KV range), 8 greedy decode steps; (iv) zamba2-7b
# (81 Mamba2 layers in 27 units, the shared block firing on 13), 4 prompts
# of 1,024 tokens (four SSD chunks of 256 each; the shared attention
# blockwise), 32 greedy tokens; (vi) xlstm-125m, 4 prompts of 1,024
# tokens (16 mLSTM chunks of 64, 1,024 sLSTM steps per sLSTM layer), 32
# greedy tokens; (vii) whisper-tiny, 4 clips of 1,500 frames
# (max_source_positions) with 64-token prompts, 32 greedy tokens.
LM_BATCH, LM_PROMPT, LM_TOKENS, LM_MAX_LEN = 4, 256, 32, 512
GEMMA2_PROMPT, GEMMA2_STEPS = 4608, 8
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_TOKENS = 4, 1024, 32
FAMILY_MAX_LEN = FAMILY_PROMPT + 64
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_MAX_LEN = 1500, 64, 128
# the serving runs are timed on the reference's init; the checks run on
# the same weights with the query and key projections rescaled to their
# true fan-in (scale_scores): the attention scores drop from the hundreds
# to O(1), bf16 rounding no longer flips a softmax row, and a small fault
# reads well above a clean run
#
# every check run prefills all but LM_CHECK_STEPS of the teacher-forced
# tokens and decodes the rest one a step; a planted fault acts on the last
# step.  The warm-up generate is LM_WARM_TOKENS long.
LM_CHECK_STEPS, LM_WARM_TOKENS = 4, 2
# the planted faults: the last decode step's cache slot (and rope
# position) moved by one, late and early
LM_FAULT_SHIFTS = (1, -1)
# decode vs prefill logits, bf16: one-position decode steps and a prefill
# over all positions round differently (cuBLAS takes other kernels and
# summation orders for the two shapes) and the differences compound over
# the layers.  Each gate sits between the clean reading and the smallest
# reading of the planted faults, which every run also takes and must see
# fail, at least 2x from either.  On an H100 (PERF.md, LM serving; clean
# on phase 2j's tokens [on random tokens]; the smallest fault on either):
# qwen3-14b 0.1816 [0.2148], 4.414; gemma2-27b 0.1035 [0.08495], 1.357;
# zamba2-7b 0.04926 [0.0605], 0.4026; xlstm-125m 0.02026 [0.0605,
# 0.1542], 0.7031; whisper-tiny 0.001953 [0.001953], 0.01855.
LM_DECODE_ATOL = {"qwen3-14b": 0.5, "gemma2-27b": 0.3, "zamba2-7b": 0.16,
                  "xlstm-125m": 0.33, "whisper-tiny": 6.5e-3}
# the same check in f32 (TF32 off) on a short case: (rows, prompt); the
# bf16 caches still round K/V and zamba2's conv state.  Clean, smallest
# fault: zamba2-7b 0.02032 [0.01817], 0.4537; xlstm-125m 8.151e-5
# [1.356e-4], 0.7059; whisper-tiny 5.066e-7, 0.02096.
F32_DECODE_CASES = {"zamba2-7b": (1, 512), "xlstm-125m": (2, 256),
                    "whisper-tiny": (2, 60)}
LM_F32_DECODE_ATOL = {"zamba2-7b": 0.09, "xlstm-125m": 5e-3,
                      "whisper-tiny": 1e-3}
# card vs host logits in f32 (TF32 off, the error on TF32 logged):
# (ii) one qwen3-14b unit, 2 x 64, last position; (v) one firing
# zamba2-7b unit (three Mamba2 blocks and the shared block with its
# LoRA), 2 x 320 (one whole SSD chunk and a partial one), every position;
# (vi) xlstm-125m whole, 2 x 256, every position.  The caches round K/V
# to bf16, and an element whose f32 value differs in its last bits
# between the two rounds to the neighbouring bf16 value.  Measured (on
# TF32): 2.98e-4 (9.0e-3), 4.8e-5 (7.16e-3), 9.46e-4 [3.65e-3] (0.265);
# an f64 run on the card lies 3.7e-5 from the zamba2 unit's f32 run and
# 5.4e-4 from xLSTM's (tools/lm_conditioning.py).
LM_UNIT_ROWS, LM_UNIT_PROMPT = 2, 64
ZAMBA_UNIT_ROWS, ZAMBA_UNIT_PROMPT = 2, 320
LM_F32_ATOL = {"qwen3-14b": 2e-3, "zamba2-7b": 5e-4, "xlstm-125m": 1e-2}


def scale_to_fan_in(params, specs):
    """Rescale the port's ``params`` in place to their true fan-in: a
    weight that reads d_model (``"fsdp"`` first) to std 1/sqrt(d_model),
    one that writes it (``"fsdp"`` last) to 1/sqrt(the dims it
    contracts).  The reference's init takes the second-to-last dim as the
    fan-in: a head count for (d, heads, d_head), 2 for (d, 2, d_ff)."""
    from repro_torch.models.common import tree_leaves
    for t, sp in zip(tree_leaves(params, torch.is_tensor),
                     tree_leaves(specs)):
        if sp.init != "normal" or "fsdp" not in sp.logical:
            continue
        j = sp.logical.index("fsdp")
        if j == len(sp.shape) - 1:
            first = next(i for i, a in enumerate(sp.logical)
                         if a is not None)
            fan = math.prod(sp.shape[first:j])
        else:
            fan = sp.shape[j]
        if fan != sp.shape[-2]:
            t.mul_(math.sqrt(sp.shape[-2] / fan))


def trainer_fan_in(tr) -> None:
    """Phase 2k (iii)'s start: the Trainer's draw at its true fan-in
    (:func:`scale_to_fan_in`; a tied embedding is also the unembedding,
    which reads d_model, so it takes std 1/sqrt(d_model) too), with fresh
    optimizer state.  At the reference's init xlstm-125m's grad norm is
    ~3e8, 99.8% of its square in the embedding, the clip scales every
    other grad below AdamW's eps, and its loss does not fall; with only
    ``scale_scores`` it still does not (tools/lm_conditioning.py)."""
    from repro_torch.optim import init_opt_state
    cfg = tr.cfg
    tr.init_state()
    scale_to_fan_in(tr.params, tr.arch.param_specs(cfg))
    if cfg.tie_embeddings:
        tr.params["embed"].mul_(math.sqrt(cfg.vocab / cfg.d_model))
    tr.opt_state = init_opt_state(tr.params, tr.opt_cfg)


def transformer_work(cfg, params, b: int, s: int, kv_len=None) -> dict:
    """The work a dense transformer's prefill of ``s`` tokens
    (``kv_len=None``) or one decode step after ``kv_len`` positions must
    do: bf16 products (every unit weight once per token, the last
    position's unembedding), f32 score products (QK^T and PV over the
    (query, key) pairs its causal and window masks keep: the port scores
    in f32, TF32 off) and bytes (every weight read once, the tokens'
    embedding rows, the K/V written, and in decode the K/V attended)."""
    from repro_torch.models.common import param_count
    from repro_torch.models.transformer import lm_param_specs
    decode = kv_len is not None
    toks = b * (1 if decode else s)
    bf16 = 2.0 * param_count(lm_param_specs(cfg)["units"]) * toks \
        + 2.0 * cfg.d_model * cfg.vocab * b
    f32 = 0.0
    kv = 0
    for kind in cfg.layer_pattern:
        w = cfg.window if kind == "local" else None
        if decode:
            pos = min(kv_len, w or kv_len) + 1
            pairs = b * pos
        else:
            pos = s
            pairs = b * sum(min(i + 1, w or s) for i in range(s))
        f32 += cfg.n_units * 4.0 * cfg.n_heads * cfg.d_head * pairs
        kv += cfg.n_units * b * 2 * cfg.n_kv * cfg.d_head * pos * 2
    emb = params["embed"]
    head = emb if cfg.tie_embeddings else params["lm_head"]
    nbytes = (_weight_bytes(params["units"]) + _weight_bytes({"h": head})
              + toks * cfg.d_model * emb.element_size() + kv)
    return {"bf16_flops": bf16, "f32_flops": f32, "bytes": float(nbytes)}


def _weight_bytes(tree) -> int:
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(tree, torch.is_tensor))


def zamba_work(cfg, params, b: int, s: int, kv_len=None) -> dict:
    """The work a zamba2 prefill of ``s`` tokens (``kv_len=None``) or one
    decode step after ``kv_len`` positions must do: bf16 products (the
    Mamba2 projections, the shared block once per firing, the last
    position's tied unembedding), f32 operations (the causal conv's taps,
    the SSD products over the causal (i, j) pairs of each chunk, or one
    SSD step; the shared attention's f32 score products over its causal
    pairs; the LoRA merge a @ b in f32 per firing) and bytes (every
    weight read once, the shared block's once per firing in decode, 694
    MB at full width and far past L2, only the firing units' LoRA; the
    SSM state (f32) and conv state read and written; the K/V attended)."""
    from repro_torch.models.zamba2 import n_fires
    sc = cfg.ssm
    d, di, n = cfg.d_model, sc.d_inner(cfg.d_model), sc.n_groups * sc.d_state
    h, hp, k, q = sc.n_heads(d), sc.head_dim, sc.d_conv, sc.chunk
    conv_dim, layers, fires = di + 2 * n, cfg.n_layers, n_fires(cfg)
    d2, nh, nkv, dh = 2 * d, cfg.n_heads, cfg.n_kv, cfg.d_head
    p_mamba = d * (2 * di + 2 * n + h) + di * d
    p_shared = d2 * (nh + 2 * nkv) * dh + nh * dh * d + d2 * 2 * cfg.d_ff \
        + cfg.d_ff * d
    merge = 2.0 * d2 * cfg.lora_rank * (nh + 2 * nkv) * dh
    decode = kv_len is not None
    toks = b * (1 if decode else s)
    bf16 = 2.0 * toks * (layers * p_mamba + fires * p_shared) \
        + 2.0 * b * d * cfg.vocab
    f32 = 2.0 * k * conv_dim * toks * layers + fires * merge
    if decode:
        f32 += 6.0 * b * h * hp * n * layers               # ssd_step
        f32 += 4.0 * nh * dh * b * (kv_len + 1) * fires
    else:
        for c0 in range(0, s, q):
            qc = min(q, s - c0)
            pairs = qc * (qc + 1) / 2
            f32 += b * layers * (2.0 * pairs * n + 2.0 * h * pairs * hp
                                 + 4.0 * h * qc * hp * n)
        f32 += 4.0 * nh * dh * b * s * (s + 1) / 2 * fires
    units = params["units"]
    mamba = _weight_bytes({kk: v for kk, v in units.items()
                           if not kk.startswith("lora")})
    lora = _weight_bytes({kk: v for kk, v in units.items()
                          if kk.startswith("lora")})
    shared = _weight_bytes(params["shared"])
    state = layers * b * (h * hp * n * 4 + (k - 1) * conv_dim * 2)
    kv_pos = (kv_len + 1) if decode else s
    nbytes = (mamba + lora * fires / (layers // 3)
              + shared * (fires if decode else 1)
              + _weight_bytes({"e": params["embed"]})
              + state * (2 if decode else 1)
              + fires * b * 2 * nkv * dh * kv_pos * 2)
    return {"bf16_flops": bf16, "f32_flops": f32, "bytes": float(nbytes),
            "lora_merge_f32_flops": fires * merge}


def xlstm_work(cfg, params, b: int, s: int, kv_len=None) -> dict:
    """xLSTM's work for a prefill of ``s`` tokens or one decode step: bf16
    products (the mLSTM's q/k/v and output projections, the sLSTM's
    output, the last position's tied unembedding), f32 operations (the
    mLSTM's gate and output-gate products, its chunked products over the
    causal pairs and the inter-chunk state, or one sequential step; the
    sLSTM's input and recurrent gate products) and bytes (every weight
    read once; the states written, and in decode read and written)."""
    from repro_torch.models.xlstm import mlstm_pdim
    d, nh, pm, ps = cfg.d_model, cfg.n_heads, mlstm_pdim(cfg), cfg.d_head
    n_s = len(cfg.slstm_layers)
    n_m = cfg.n_layers - n_s
    q = cfg.ssm.chunk if cfg.ssm else 64
    decode = kv_len is not None
    toks = b * (1 if decode else s)
    bf16 = 2.0 * toks * (n_m * 4 * d * nh * pm + n_s * nh * ps * d) \
        + 2.0 * b * d * cfg.vocab
    f32 = 2.0 * toks * (n_m * (d * nh * pm + 2 * d * nh)
                        + n_s * (4 * d * nh * ps + 4 * nh * ps * ps))
    if decode:
        f32 += 5.0 * b * nh * pm * pm * n_m
    else:
        for c0 in range(0, s, q):
            qc = min(q, s - c0)
            pairs = qc * (qc + 1) / 2
            f32 += b * nh * n_m * (4.0 * pairs * pm + 4.0 * qc * pm * pm)
    state = n_m * b * nh * (pm * pm + pm + 1) * 4 + n_s * b * nh * ps * 16
    nbytes = _weight_bytes(params) + state * (2 if decode else 1)
    return {"bf16_flops": bf16, "f32_flops": f32, "bytes": float(nbytes)}


def whisper_work(cfg, params, b: int, s: int, kv_len=None,
                 frames: int = WHISPER_FRAMES) -> dict:
    """Whisper's work for a prefill (``frames`` encoded, ``s`` prompt
    tokens) or one decode step: bf16 products (the encoder's and the
    decoder's projections, the cross K/V once, the tied unembedding of
    the last position), f32 score products (the encoder's over all frame
    pairs, the decoder's causal self pairs and its cross pairs) and bytes
    (prefill: every weight once, the caches written; decode: the decoder
    weights less the cross K/V projections, the embedding, one position
    row, and the self and cross K/V read)."""
    d, f, nh, nkv, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv, \
        cfg.d_head
    le, ld = cfg.encoder_layers, cfg.n_layers
    dec_w = 4 * d * nh * dh + 2 * d * nh * dh + 2 * d * f
    decode = kv_len is not None
    if decode:
        bf16 = 2.0 * b * (ld * dec_w + d * cfg.vocab)
        f32 = 4.0 * nh * dh * b * ld * (kv_len + 1 + frames)
        dec = params["dec_layers"]
        cross_kv_w = _weight_bytes({kk: dec["cross_attn"][kk]
                                    for kk in ("wk", "wv")})
        nbytes = (_weight_bytes(dec) - cross_kv_w
                  + _weight_bytes({"e": params["embed"],
                                   "n": params["ln_dec"]})
                  + d * params["pos_dec"].element_size()
                  + ld * b * 2 * nkv * dh * (kv_len + 1 + frames) * 2)
    else:
        bf16 = (2.0 * b * frames * le * (4 * d * nh * dh + 2 * d * f)
                + 2.0 * b * frames * ld * 2 * d * nkv * dh
                + 2.0 * b * s * ld * dec_w + 2.0 * b * d * cfg.vocab)
        f32 = (4.0 * nh * dh * b * frames * frames * le
               + 4.0 * nh * dh * b * ld * (s * (s + 1) / 2 + s * frames))
        nbytes = (_weight_bytes(params) - params["pos_dec"].numel()
                  * params["pos_dec"].element_size()
                  + s * d * params["pos_dec"].element_size()
                  + ld * b * 2 * nkv * dh * (s + frames) * 2)
    return {"bf16_flops": bf16, "f32_flops": f32, "bytes": float(nbytes)}


def work_bound_ms(work: dict, rates: dict):
    """(ms, by): the larger of the bytes over the HBM rate and the
    operations at their type's rate (bf16 on the tensor cores, f32 on the
    CUDA cores without TF32, the two summed: the port runs them one
    after another)."""
    t_bytes = work["bytes"] / rates["bytes"]
    t_ops = work["bf16_flops"] / rates["bf16"] + work["f32_flops"] \
        / rates["f32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lm_init(failures, cfg, seed, label):
    """``cfg``'s params from a seeded CUDA generator: ``n_params(cfg)`` in
    all, each leaf in its spec's dtype (bf16 but for the few f32 gate and
    decay leaves of zamba2 and xLSTM).  Returns (arch, params, record)."""
    from repro_torch.models import make_arch
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.roofline.analysis import n_params
    arch = make_arch(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(torch.Generator("cuda").manual_seed(seed),
                         arch.param_specs(cfg))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    leaves = list(tree_leaves(params, torch.is_tensor))
    specs = list(tree_leaves(arch.param_specs(cfg)))
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    if n != n_params(cfg) or [t.dtype for t in leaves] != \
            [sp.dtype for sp in specs]:
        failures.append(f"phase 2j {label}: {n} params, n_params "
                        f"{n_params(cfg)}, dtypes "
                        f"{sorted({str(t.dtype) for t in leaves})}")
    log(f"phase 2j {label}: {cfg.arch} init_params {n / 1e9:.3f}e9 "
        f"params ({nbytes / 1e9:.2f} GB) in {init_s:.2f}s")
    return arch, params, {"init_s": init_s, "params": n,
                          "param_bytes": nbytes}


def _state_part(st, key, index):
    """The state under ``key`` (index ``index`` of its stacked leaves, or
    all of it with ``None``), as views."""
    from repro_torch.models.common import tree_map
    part = st[key]
    return part if index is None else tree_map(lambda t: t[index], part,
                                               torch.is_tensor)


def lm_decode_run(arch, cfg, params, prompt, toks, s, max_len, fault=None):
    """Prefill toks[:, :s] (with the prompt's other inputs: Whisper's
    frames), then decode the rest of ``toks`` one token a step
    (teacher-forced), each step timed with CUDA events and synchronized.
    Returns the step times and the last step's logits.  ``fault`` plants
    one in the last step: ``("slot", k)`` tells it a cache length k off,
    so it writes its K/V k slots away (and ropes or embeds its position k
    off); ``("state", (key, index))`` runs it from the recurrent state of
    one layer (``_state_part``) that the step before it started from, so
    that layer loses one update; ``("cross", None)`` takes each clip's
    cross K/V from the next clip."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.sharding import ShardCtx
    ctx = ShardCtx()
    kind, arg = fault or (None, None)
    times = []
    last = toks.shape[1] - 1
    with torch.inference_mode():
        st, n, _ = arch.prefill(params, dict(prompt, tokens=toks[:, :s]),
                                cfg, ctx, max_len=max_len)
        for i in range(s, toks.shape[1]):
            if kind == "state" and i == last - 1:
                saved = tree_map(torch.clone, _state_part(st, *arg),
                                 torch.is_tensor)
            if i == last and kind == "slot":
                n += arg
            elif i == last and kind == "state":
                for live, old in zip(
                        tree_leaves(_state_part(st, *arg), torch.is_tensor),
                        tree_leaves(saved, torch.is_tensor)):
                    live.copy_(old)
            elif i == last and kind == "cross":
                st = dict(st, cross={k: torch.roll(v, 1, dims=1)
                                     for k, v in st["cross"].items()})
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            st, n, step = arch.decode(params, st, n, toks[:, i:i + 1], cfg,
                                      ctx)
            e.record()
            e.synchronize()
            times.append(a.elapsed_time(e))
    return times, step[:, -1]


def lm_profiled(fn, name, reps):
    """``fn`` run ``reps`` times under ``torch.profiler``: device busy
    time (the union of kernels and copies), the device's idle share
    between its first and last event, kernels per call and the kernels
    that take the most time (``build/lm_<name>.json``)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in trace_events(prof, os.path.join(
        ROOT, "build", f"lm_{name}.json")) if is_device(e)]
    iv = spans(dev, lambda e: True)
    on = busy(iv)
    window = max(b for _, b in iv) - min(a for a, _ in iv)
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"calls": reps, "device_busy_ms": on / 1e3 / reps,
            "device_window_ms": window / 1e3 / reps,
            "idle_share": 1.0 - on / window,
            "kernels_per_call": sum(e.get("cat") == "kernel"
                                    for e in dev) / reps,
            "top_ms_per_call": {k[:80]: v / 1e3 / reps for k, v in top}}


def lm_check(failures, label, arch, cfg, params, prompt, toks, max_len,
             faults, gate):
    """The reference's invariant (tests/test_models.py): the last decode
    step's logits equal a prefill's over the same tokens.  Prefills all
    but ``LM_CHECK_STEPS`` of ``toks`` and decodes the rest, clean and
    with each of ``faults`` (see ``lm_decode_run``); fails unless the
    clean run reads within ``gate`` and every fault above it.  Returns
    the record."""
    from repro_torch.sharding import ShardCtx
    s = toks.shape[1] - LM_CHECK_STEPS
    with torch.inference_mode():
        ref = arch.prefill(params, dict(prompt, tokens=toks), cfg,
                           ShardCtx(), max_len=max_len)[2][:, -1]
    readings = {}
    for name, fault in {"clean": None, **faults}.items():
        step = lm_decode_run(arch, cfg, params, prompt, toks, s, max_len,
                             fault)[1]
        readings[name] = float((step - ref).abs().max())
        if not bool(torch.isfinite(step).all()) \
                or (name == "clean") != (readings[name] <= gate):
            failures.append(f"phase 2j {label}: decode vs prefill logits "
                            f"({name}) read {readings[name]}, gate {gate}")
    log(f"  2j {label} check, {tuple(toks.shape)} tokens, "
        f"{LM_CHECK_STEPS} decode steps: decode vs prefill logits max |d| "
        + ", ".join(f"{k} {v:.4g}" for k, v in readings.items())
        + f" (gate {gate}; |logit| <= {float(ref.abs().max()):.3g})")
    return {"rows": toks.shape[0], "tokens": toks.shape[1],
            "steps": LM_CHECK_STEPS, "gate": gate, "max_abs": readings,
            "logit_max_abs": float(ref.abs().max())}


def lm_serve(failures, label, arch, cfg, params, prompt, n_tokens, max_len,
             prefill_reps, work, rates, smi):
    """Serve ``prompt`` on the reference's init and time it: greedy
    tokens within the vocabulary, prefill ms and tokens/s, decode ms per
    step (median of the teacher-forced steps, synchronized) beside their
    bounds from ``work(cfg, params, b, s, kv_len=None)``, peak memory, one
    prefill and three decode steps under ``torch.profiler``.  Returns the
    row and the teacher-forced tokens (the prompt and the greedy ones)."""
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import ShardCtx
    ctx = ShardCtx()
    eng = ServeEngine(arch, params, max_len=max_len)
    eng.generate(prompt, LM_WARM_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompt, n_tokens)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    b, s = prompt["tokens"].shape
    if (out.shape != (b, n_tokens) or out.dtype != torch.int32
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab):
        failures.append(f"phase 2j {label}: tokens {tuple(out.shape)} "
                        f"{out.dtype} in [{int(out.min())}, "
                        f"{int(out.max())}], vocab {cfg.vocab}")
    with torch.inference_mode():
        pre_ms = time_ms(lambda: arch.prefill(
            params, prompt, cfg, ctx, max_len=max_len),
            reps=prefill_reps, warmup=1)
    toks = torch.cat([prompt["tokens"], out[:, :-1]], dim=1)
    times = lm_decode_run(arch, cfg, params, prompt, toks, s, max_len)[0]
    with torch.inference_mode():
        prof_pre = lm_profiled(lambda: arch.prefill(
            params, prompt, cfg, ctx, max_len=max_len), "prefill", 1)
        state = list(arch.prefill(params, prompt, cfg, ctx,
                                  max_len=max_len)[:2])

        def step():
            state[:2] = arch.decode(params, *state, out[:, :1], cfg,
                                    ctx)[:2]
        prof_dec = lm_profiled(step, "decode", 3)
    dec_ms = statistics.median(times)
    kv_mid = s + len(times) // 2
    pre_work = work(cfg, params, b, s)
    dec_work = work(cfg, params, b, 1, kv_len=kv_mid)
    pre_bound, pre_by = work_bound_ms(pre_work, rates)
    dec_bound, dec_by = work_bound_ms(dec_work, rates)
    row = {"batch": b, "prompt": s, "n_tokens": n_tokens,
           "max_len": max_len, "generate_ms": gen_ms,
           "prefill_ms": pre_ms, "prefill_tokens_per_s":
           b * s / pre_ms * 1e3, "prefill_bound_ms": pre_bound,
           "prefill_bound_by": pre_by, "prefill_work": pre_work,
           "decode_ms_median": dec_ms, "decode_ms": times,
           "decode_bound_ms": dec_bound, "decode_bound_by": dec_by,
           "decode_work": dec_work,
           "prefill_trace": prof_pre, "decode_trace": prof_dec,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"phase 2j {label}: generate {b}x{s} -> {n_tokens} tokens in "
        f"{gen_ms:.1f} ms; prefill {pre_ms:.2f} ms "
        f"({row['prefill_tokens_per_s']:.0f} tokens/s; bound "
        f"{pre_bound:.2f} ms by {pre_by}, {pre_bound / pre_ms:.2f} of "
        f"it); decode {dec_ms:.2f} ms/step (median of {len(times)}, "
        f"bound {dec_bound:.2f} ms by {dec_by}, "
        f"{dec_bound / dec_ms:.2f} of it); peak {row['peak_gib']:.2f} GiB "
        f"| {smi}")
    for what, tr in (("prefill", prof_pre), ("decode step", prof_dec)):
        log(f"  2j {label} {what} under torch.profiler: device busy "
            f"{tr['device_busy_ms']:.2f} of {tr['device_window_ms']:.2f}"
            f" ms (idle {tr['idle_share']:.2f}), "
            f"{tr['kernels_per_call']:.0f} kernels; top "
            + "; ".join(f"{k[:48]} {v:.2f}"
                        for k, v in tr["top_ms_per_call"].items()))
    return row, toks


def lm_serve_and_check(failures, label, arch, cfg, params, prompt, n_tokens,
                       max_len, prefill_reps, work, rates, smi, faults):
    """``lm_serve`` on the reference's init, then ``scale_scores`` (in
    place: the case's later checks see the rescaled weights too) and
    ``lm_check`` in bf16 against ``LM_DECODE_ATOL``.  Returns the row and
    the teacher-forced tokens."""
    from repro_torch.models.common import scale_scores
    row, toks = lm_serve(failures, label, arch, cfg, params, prompt,
                         n_tokens, max_len, prefill_reps, work, rates, smi)
    scale_scores(params, arch.param_specs(cfg))
    row["check"] = lm_check(failures, label, arch, cfg, params, prompt,
                            toks, max_len, faults, LM_DECODE_ATOL[cfg.arch])
    return row, toks


def lm_f32_check(failures, label, arch, cfg, params, prompt, toks, faults):
    """``lm_check`` in f32 (TF32 off) on ``F32_DECODE_CASES[cfg.arch]``
    against ``LM_F32_DECODE_ATOL``.  Frees ``params``."""
    from repro_torch.models.common import tree_map
    b, s = F32_DECODE_CASES[cfg.arch]
    p32 = tree_map(lambda t: t.float(), params, torch.is_tensor)
    params.clear()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        failures.append(f"phase 2j {label}: TF32 is on")
    rec = lm_check(failures, label + " f32", arch, cfg, p32,
                   {k: v[:b].float() for k, v in prompt.items()},
                   toks[:b, :s + LM_CHECK_STEPS], s + 2 * LM_CHECK_STEPS,
                   faults, LM_F32_DECODE_ATOL[cfg.arch])
    del p32
    torch.cuda.empty_cache()
    return rec


def lm_card_vs_host(failures, label, fn, params, toks, gate):
    """``fn(params, toks)`` in f32 on the card (TF32 off), again on TF32
    (logged), and on the host's CPU; fails above ``gate``.  Frees the
    card's copy of ``params``.  Returns the record."""
    from repro_torch.models.common import tree_map
    if torch.backends.cuda.matmul.allow_tf32:
        failures.append(f"phase 2j {label}: TF32 is on")
    with torch.inference_mode():
        card = fn(params, toks).cpu()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fn(params, toks).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        host_params = tree_map(lambda t: t.cpu(), params, torch.is_tensor)
        params.clear()
        torch.cuda.empty_cache()
        t0 = time.time()
        host = fn(host_params, toks.cpu())
        host_s = time.time() - t0
    err = float((card - host).abs().max())
    tf32_err = float((tf32 - host).abs().max())
    if not (torch.isfinite(card).all() and err <= gate):
        failures.append(f"phase 2j {label}: card vs host logits max |d| "
                        f"{err} (limit {gate})")
    rows, n = toks.shape
    log(f"phase 2j {label}: f32, {rows}x{n} logits: card vs host max |d| "
        f"{err:.3g} (limit {gate}; on TF32 {tf32_err:.3g}; |logit| <= "
        f"{float(host.abs().max()):.3g}; host {host_s:.1f}s)")
    return {"rows": rows, "prompt": n, "card_vs_host_max_abs": err,
            "tf32_vs_host_max_abs": tf32_err, "gate": gate,
            "logit_max_abs": float(host.abs().max()), "host_s": host_s}


def _slot_faults():
    return {f"slot {k:+d}": ("slot", k) for k in LM_FAULT_SHIFTS}


def qwen3_cases(failures, smi, rates):
    """Phase 2j (i) qwen3-14b served, (ii) one of its units in f32, card
    vs host."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.sharding import ShardCtx
    cfg = get_config("qwen3-14b")
    arch, params, init = lm_init(failures, cfg, SEED, "(i)")
    tg = torch.Generator("cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=tg,
                         device="cuda", dtype=torch.int32)
    row, _ = lm_serve_and_check(failures, "(i) qwen3-14b", arch, cfg, params,
                                {"tokens": toks}, LM_TOKENS, LM_MAX_LEN, 5,
                                transformer_work, rates, smi, _slot_faults())
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    unit = {k: (tree_map(lambda t: t[:1].float(), v, torch.is_tensor)
                if k == "units" else v.float()) for k, v in params.items()}
    del params
    f32 = lm_card_vs_host(
        failures, "(ii) qwen3-14b unit",
        lambda p, tk: arch.prefill(p, {"tokens": tk}, cfg1, ShardCtx(),
                                   max_len=LM_UNIT_PROMPT)[2],
        unit, toks[:LM_UNIT_ROWS, :LM_UNIT_PROMPT], LM_F32_ATOL[cfg.arch])
    return {"qwen3_14b": row | init, "qwen3_14b_unit_f32": f32}


def gemma2_cases(failures, smi, rates):
    """Phase 2j (iii) gemma2-27b served."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-27b")
    arch, params, init = lm_init(failures, cfg, SEED + 2, "(iii)")
    max_len = GEMMA2_PROMPT + 2 * GEMMA2_STEPS
    if not (GEMMA2_PROMPT > cfg.window
            and GEMMA2_PROMPT * max_len > 512 * 512):
        failures.append("phase 2j (iii): the prompt does not pass the "
                        "window and the blockwise threshold")
    tg = torch.Generator("cuda").manual_seed(SEED + 9)
    toks = torch.randint(0, cfg.vocab, (1, GEMMA2_PROMPT), generator=tg,
                         device="cuda", dtype=torch.int32)
    row, _ = lm_serve_and_check(failures, "(iii) gemma2-27b", arch, cfg,
                                params, {"tokens": toks}, GEMMA2_STEPS + 1,
                                max_len, 3, transformer_work, rates, smi,
                                _slot_faults())
    del params
    return {"gemma2_27b": row | init}


def zamba_cases(failures, smi, rates):
    """Phase 2j (iv) zamba2-7b served, checked in bf16 and in f32; (v) one
    of its firing units (three Mamba2 blocks and the shared block with the
    unit's LoRA) in f32, card vs host."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import rms_norm, tree_map
    from repro_torch.models.transformer import embed, unembed
    from repro_torch.models.zamba2 import n_fires, zamba_unit
    from repro_torch.sharding import ShardCtx
    ctx = ShardCtx()
    cfg = get_config("zamba2-7b")
    arch, params, init = lm_init(failures, cfg, SEED + 3, "(iv)")
    tg = torch.Generator("cuda").manual_seed(SEED + 4)
    toks = torch.randint(0, cfg.vocab, (FAMILY_BATCH, FAMILY_PROMPT),
                         generator=tg, device="cuda", dtype=torch.int32)
    if not (FAMILY_PROMPT == 4 * cfg.ssm.chunk and n_fires(cfg) == 13
            and FAMILY_PROMPT * FAMILY_MAX_LEN > 512 * 512):
        failures.append("phase 2j (iv): not four SSD chunks, 13 firings "
                        "and blockwise shared attention")
    # one Mamba2 layer of 81 loses its update: the first, which feeds the
    # shared block's first firing (a later layer's lost update reads as a
    # clean run: PERF.md)
    faults = _slot_faults() | {"lost update": ("state", ("ssm_0", 0))}
    row, tf = lm_serve_and_check(failures, "(iv) zamba2-7b", arch, cfg,
                                 params, {"tokens": toks}, FAMILY_TOKENS,
                                 FAMILY_MAX_LEN, 2, zamba_work, rates, smi,
                                 faults)
    merge = row["decode_work"]["lora_merge_f32_flops"]
    row |= init | {"fires": n_fires(cfg), "lora_merge_f32_flops": merge,
                   "lora_merge_ms_at_f32_rate": merge / rates["f32"] * 1e3}
    log(f"  2j (iv) the LoRA merge: {n_fires(cfg)} firings x "
        f"{merge / n_fires(cfg) / 1e9:.1f} GFLOP f32 per call, "
        f"{merge / rates['f32'] * 1e3:.2f} ms at {rates['f32']:.3g} FLOP/s")
    unit = {"up": tree_map(lambda t: t[1].float(), params["units"],
                           torch.is_tensor),
            "shared": tree_map(lambda t: t.float(), params["shared"],
                               torch.is_tensor),
            "embed": params["embed"].float(),
            "ln_final": params["ln_final"].float()}
    row["f32_check"] = lm_f32_check(failures, "(iv) zamba2-7b", arch, cfg,
                                    params, {}, tf, faults)
    del params

    def unit_logits(p, tk):             # every position's logits
        h0 = embed(p, tk, cfg, ctx)
        h = zamba_unit(cfg, ctx, p["shared"], p["up"], h0, h0, None,
                       fire=True)
        return unembed(p, rms_norm(h, p["ln_final"], cfg.norm_eps), cfg,
                       ctx)

    f32 = lm_card_vs_host(failures, "(v) zamba2-7b unit", unit_logits, unit,
                          toks[:ZAMBA_UNIT_ROWS, :ZAMBA_UNIT_PROMPT],
                          LM_F32_ATOL[cfg.arch])
    return {"zamba2_7b": row, "zamba2_7b_unit_f32": f32}


def xlstm_cases(failures, smi, rates):
    """Phase 2j (vi) xlstm-125m served, checked in bf16 and in f32, and
    whole in f32, card vs host."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import embed, unembed
    from repro_torch.models.xlstm import _layer_keys, xlstm_apply
    from repro_torch.sharding import ShardCtx
    ctx = ShardCtx()
    cfg = get_config("xlstm-125m")
    arch, params, init = lm_init(failures, cfg, SEED + 5, "(vi)")
    tg = torch.Generator("cuda").manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab, (FAMILY_BATCH, FAMILY_PROMPT),
                         generator=tg, device="cuda", dtype=torch.int32)
    # one block of 12 loses its update: the first
    first = _layer_keys(cfg)[0][0]
    faults = {"lost update": ("state", (first, None))}
    row, tf = lm_serve_and_check(failures, "(vi) xlstm-125m", arch, cfg,
                                 params, {"tokens": toks}, FAMILY_TOKENS,
                                 FAMILY_MAX_LEN, 2, xlstm_work, rates, smi,
                                 faults)
    p32 = tree_map(lambda t: t.float(), params, torch.is_tensor)
    row["f32_check"] = lm_f32_check(failures, "(vi) xlstm-125m", arch, cfg,
                                    params, {}, tf, faults)
    del params
    rows, n = F32_DECODE_CASES[cfg.arch]

    def logits(p, tk):                  # every position's logits
        return unembed(p, xlstm_apply(p, embed(p, tk, cfg, ctx), cfg,
                                      ctx)[0], cfg, ctx)

    f32 = lm_card_vs_host(failures, "(vi) xlstm-125m whole", logits, p32,
                          toks[:rows, :n], LM_F32_ATOL[cfg.arch])
    return {"xlstm_125m": row | init, "xlstm_125m_f32": f32}


def whisper_cases(failures, smi, rates):
    """Phase 2j (vii) whisper-tiny served, checked in bf16 and in f32."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-tiny")
    arch, params, init = lm_init(failures, cfg, SEED + 7, "(vii)")
    tg = torch.Generator("cuda").manual_seed(SEED + 8)
    frames = torch.randn((FAMILY_BATCH, WHISPER_FRAMES, cfg.d_model),
                         generator=tg, device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (FAMILY_BATCH, WHISPER_PROMPT),
                         generator=tg, device="cuda", dtype=torch.int32)
    if not (WHISPER_FRAMES == cfg.max_source_positions
            and WHISPER_FRAMES ** 2 > 512 * 512):
        failures.append("phase 2j (vii): the encoder does not run "
                        "blockwise over max_source_positions frames")
    faults = _slot_faults() | {"cross K/V of the next clip": ("cross", None)}
    row, tf = lm_serve_and_check(failures, "(vii) whisper-tiny", arch, cfg,
                                 params, {"tokens": toks, "frames": frames},
                                 FAMILY_TOKENS, WHISPER_MAX_LEN, 5,
                                 whisper_work, rates, smi, faults)
    row["f32_check"] = lm_f32_check(failures, "(vii) whisper-tiny", arch,
                                    cfg, params, {"frames": frames}, tf,
                                    faults)
    return {"whisper_tiny": row | init | {"frames": WHISPER_FRAMES}}


def lm_phase(failures, smi, hbm_bw, peak_bf16, peak_f32):
    """Phase 2j: LM serving on the card (see the module docstring), one
    model at a time, each freed before the next.  Returns the record."""
    t_phase = time.time()
    rates = {"bytes": hbm_bw, "bf16": peak_bf16, "f32": peak_f32}
    rec = {"card": smi, "seconds_per_model": {}}
    for cases in (qwen3_cases, gemma2_cases, zamba_cases, xlstm_cases,
                  whisper_cases):
        t0 = time.time()
        torch.cuda.empty_cache()
        rec |= cases(failures, smi, rates)
        rec["seconds_per_model"][cases.__name__] = time.time() - t0
    rec["seconds"] = time.time() - t_phase
    log(f"phase 2j: {rec['seconds']:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s"
                    for k, v in rec["seconds_per_model"].items()) + ")")
    return rec


# phase 2k: LM training (repro_torch.train, optim, checkpointing, data):
# plain PyTorch and autograd, no TPU kernel on this path (PERF.md, kernel
# table).  Full width, depth cut where the state must fit the card's
# 80 GB (PERF.md, Cells): (i) qwen3-14b, 4 of its 40 layers (2.877e9
# params; bf16 param and grad, f32 master, m and v: 16 B/param, 46.0 GB),
# remat on (its default), 4 x 1,024 tokens, AdamW with f32 state;
# (ii) olmoe-1b-7b, 4 of its 16 layers (1.884e9 params, 0.475e9 active,
# 64 experts, top-8), 4 x 1,024 tokens in two microbatches
# (accum_steps=2), 8-bit AdamW state and int8 gradient compression with
# error feedback; (iii) xlstm-125m whole (its remat=False) through the
# Trainer at its own 8 x 128: checkpoints, an injected failure, a resume;
# (iv) one full-width qwen3-14b layer with the full vocabulary (1.886e9
# params) in f32, 2 x 64 tokens in two microbatches, one step, card
# against host.  Data is batch_for_step(DataConfig(vocab, seq, batch,
# seed), step).
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 4, 10
# the planted sign flip runs this many steps with the learning rate
# negated, from the clean run's end
TRAIN_FLIP_STEPS = 3
# (i) and (ii): warmup 2, then a cosine that barely decays over the run
# (total 1000), so the flipped steps take the clean run's rate
TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 2, "total_steps": 1000}
# (i) and (ii): the loss falls by at least this many nats over a clean
# run's steps (its first step's loss less its last's), and a planted sign
# flip of the update must read below it (``flipped_fall``: the flipped
# steps' batches, their mean loss before less after).  On an H100
# (PERF.md, Training): (i) fell 10.14 clean, -19.51 flipped; (ii) 4.43,
# -3.73.
TRAIN_FALL_GATE = 1.0
# (iii): a straight run of TRAINER_STEPS steps; Trainer.run with a
# checkpoint every TRAINER_CKPT_EVERY and an injected failure at
# TRAINER_FAIL_AT; a new Trainer that resumes; the reference's trainer
# test's optimizer.  The end states must be equal.  The params are the
# Trainer's draw at its true fan-in (``trainer_fan_in``).  The straight
# run's batches' mean loss falls by TRAINER_FALL_GATE nats or more over
# it, and with the update's sign flipped by less: xlstm-125m learns
# slowly here beside a batch-to-batch spread of up to 0.1 nats, so the
# fall is read on the same batches before and after (on an H100: 0.2069
# clean, -0.1174 flipped; PERF.md, Training).
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_FAIL_AT = 5, 3, 4
TRAINER_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 50}
TRAINER_FALL_GATE = 0.05
# (iv): card against host, f32, TF32 off; each quantity's error over its
# gate, the reading is the largest (PERF.md, Training: the update read
# 2.8e-4 clean and 0.396 with the bias correction one step off; m and the
# grads 5.5e-6 clean).  loss: relative; grads, m and v: max |d|
# over the leaf's max |x|, the largest over leaves; update:
# ||d(new - old)|| / ||new - old|| per leaf (Adam's first step moves an
# entry by about lr * sign(g), and the card and the host may part on the
# sign of entries whose g is at the rounding level).
TRAIN_CHECK_ROWS, TRAIN_CHECK_SEQ = 2, 64
TRAIN_CHECK_OPT = {"lr": 1e-3, "warmup_steps": 0, "total_steps": 10**9,
                   "grad_clip": 0.25}
TRAIN_CHECK_GATES = {"loss": 1e-5, "update": 3e-3, "m": 1e-4, "v": 2e-4,
                     "grads": 1e-4}


def train_work(cfg, params, opt_state, err, tokens: int) -> dict:
    """One training step's model FLOPs (``model_flops``: 6 x active
    params x tokens; remat's recompute not counted) and the optimizer's
    state bytes: every state leaf (master, m, v and their scales, the
    error feedback) read and written once, the grads read once (f32 when
    accumulated, else in the params' dtype) and the params written
    once."""
    from repro_torch.models.registry import ShapeCell
    from repro_torch.roofline.analysis import model_flops
    n = sum(t.numel() for t in _leaves(params))
    state = opt_state["master"], opt_state["m"], opt_state["v"], err
    grad_bytes = 4 * n if cfg.accum_steps > 1 else _weight_bytes(params)
    return {"flops": model_flops(cfg, ShapeCell("train", tokens, 1,
                                                "train")),
            "state_bytes": float(2 * sum(_weight_bytes(s) for s in state
                                         if s is not None)
                                 + grad_bytes + _weight_bytes(params))}


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return list(tree_leaves(tree, torch.is_tensor))


def train_bound_ms(work: dict, rates: dict, rate: str = "bf16"):
    """(ms, by): the larger of the FLOPs at the tensor rate ``rates[rate]``
    and the state bytes at the HBM rate."""
    t_ops = work["flops"] / rates[rate]
    t_bytes = work["state_bytes"] / rates["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _init_train(cfg, seed):
    from repro_torch.models import make_arch
    from repro_torch.models.common import init_params
    arch = make_arch(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator("cuda").manual_seed(seed),
                         arch.param_specs(cfg))
    return arch, params


def batches_loss(arch, params, data, steps) -> float:
    """The mean loss of ``params`` over the batches of ``steps``."""
    from repro_torch.data import batch_for_step
    from repro_torch.sharding import ShardCtx
    with torch.no_grad():
        return statistics.fmean(
            float(arch.loss(params, batch_for_step(data, i), arch.cfg,
                            ShardCtx())[0]) for i in steps)


def flipped_fall(arch, opt, params, opt_state, err, data, start: int,
                 n: int = TRAIN_FLIP_STEPS) -> float:
    """The planted fault: ``n`` steps with the learning rate negated (the
    update's sign flipped) from the given state on batches ``start``..;
    returns the loss fall on those batches (their mean loss before the
    flipped steps less after)."""
    from repro_torch.data import batch_for_step
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    steps = range(start, start + n)
    before = batches_loss(arch, params, data, steps)
    flip = make_train_step(arch, dataclasses.replace(opt, lr=-opt.lr),
                           ShardCtx(), compression=err is not None)
    for i in steps:
        flip(params, opt_state, batch_for_step(data, i),
             *([err] if err is not None else []))
    return before - batches_loss(arch, params, data, steps)


def fall_checks(failures, label, fall, flip, gate, steps) -> None:
    """The loss fall over a clean run of ``steps`` steps must reach
    ``gate`` and the sign-flipped fall ``flip`` stay below it."""
    if not fall >= gate:
        failures.append(f"phase 2k {label}: the loss fell {fall:.4g} nats "
                        f"over {steps} steps (gate {gate})")
    if not flip < gate:
        failures.append(f"phase 2k {label}: with the update's sign flipped "
                        f"the loss fell {flip:.4g} nats (gate {gate})")


def train_case(failures, label, cfg, opt, compression, rates, smi):
    """Phase 2k (i)/(ii): ``TRAIN_STEPS`` steps of ``make_train_step`` on
    the card, each synchronized and timed, one more under
    ``torch.profiler``, then the planted sign flip.  Returns the record."""
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.optim import apply_updates, compress, init_opt_state
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    t0 = time.time()
    arch, params = _init_train(cfg, SEED + 10)
    opt_state = init_opt_state(params, opt)
    err = compress.init_error(params) if compression else None
    init_s = time.time() - t0
    step = make_train_step(arch, opt, ShardCtx(), compression=compression)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=SEED)
    extra = [err] if compression else []
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        batch = batch_for_step(data, i)
        torch.cuda.synchronize()
        a = time.perf_counter()
        out = step(params, opt_state, batch, *extra)
        losses.append(float(out[2]["loss_total"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - a) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    # one more step in its two parts: the grads (forward, remat's
    # recompute, backward), then compression and the AdamW update
    batch = batch_for_step(data, TRAIN_STEPS)
    torch.cuda.synchronize()
    a = time.perf_counter()
    _, _, grads = step.grads_of(params, batch)
    torch.cuda.synchronize()
    b = time.perf_counter()
    if compression:
        grads, _ = compress.compress_tree(grads, err)
    apply_updates(params, grads, opt_state, opt)
    torch.cuda.synchronize()
    split = {"grads_ms": (b - a) * 1e3,
             "update_ms": (time.perf_counter() - b) * 1e3}
    del grads
    prof = lm_profiled(lambda: step(params, opt_state,
                                    batch_for_step(data, TRAIN_STEPS + 1),
                                    *extra),
                       f"train_{label.strip('()')}", 1)
    flip = flipped_fall(arch, opt, params, opt_state, err, data,
                        TRAIN_STEPS + 2)
    fall = (losses[0] - losses[-1] if all(map(math.isfinite, losses))
            else math.nan)
    fall_checks(failures, label, fall, flip, TRAIN_FALL_GATE, TRAIN_STEPS)
    work = train_work(cfg, params, opt_state, err, TRAIN_BATCH * TRAIN_SEQ)
    bound, by = train_bound_ms(work, rates)
    med = statistics.median(times)
    rec = {"arch": cfg.arch, "n_layers": cfg.n_layers,
           "params": sum(t.numel() for t in _leaves(params)),
           "state_bytes": sum(_weight_bytes(s) for s in
                              (params, opt_state, err) if s is not None),
           "accum_steps": cfg.accum_steps, "remat": cfg.remat,
           "quantize_state": opt.quantize_state, "compression": compression,
           "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ, "losses": losses,
           "step_ms": times, "step_ms_median": med, "split": split,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
           "model_flops": work["flops"], "work": work, "bound_ms": bound,
           "bound_by": by, "share_of_bound": bound / med,
           "peak_gib": peak / 2**30, "init_s": init_s, "trace": prof,
           "fall": fall, "flipped_fall": flip, "gate": TRAIN_FALL_GATE}
    log(f"phase 2k {label}: {cfg.arch} {cfg.n_layers} layers, "
        f"{rec['params'] / 1e9:.3f}e9 params, state "
        f"{rec['state_bytes'] / 1e9:.2f} GB, {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"tokens, accum {cfg.accum_steps}, remat {cfg.remat}, 8-bit state "
        f"{opt.quantize_state}, compression {compression}: step "
        f"{med:.1f} ms median ({min(times):.1f}-{max(times):.1f}; one "
        f"more split: grads {split['grads_ms']:.1f} ms, compression and "
        f"update {split['update_ms']:.1f} ms), "
        f"{rec['tokens_per_s']:.0f} tokens/s; model {work['flops']:.4g} "
        f"FLOP, state {work['state_bytes'] / 1e9:.2f} GB -> bound "
        f"{bound:.2f} ms ({by}), {rec['share_of_bound']:.3f} of it; "
        f"{prof['kernels_per_call']:.0f} kernels per step, idle "
        f"{prof['idle_share']:.3f}; peak {rec['peak_gib']:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (fell {fall:.3f}, gate "
        f"{TRAIN_FALL_GATE}; sign flipped: fell {flip:.3f}) | {smi}")
    del params, opt_state, err
    torch.cuda.empty_cache()
    return rec


def qwen3_train_case(failures, smi, rates):
    """Phase 2k (i)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=4)
    if not cfg.remat:
        failures.append("phase 2k (i): remat is off")
    return train_case(failures, "(i)", cfg, AdamWConfig(**TRAIN_OPT), False,
                      rates, smi)


def olmoe_train_case(failures, smi, rates):
    """Phase 2k (ii)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=4,
                              accum_steps=2)
    return train_case(failures, "(ii)", cfg,
                      AdamWConfig(**TRAIN_OPT, quantize_state=True), True,
                      rates, smi)


def _state_gap(a, b) -> tuple[bool, float]:
    """(every leaf equal, the largest |a - b|) over two state trees."""
    equal, gap = True, 0.0
    for x, y in zip(_leaves(a), _leaves(b)):
        x, y = x.detach(), y.detach()
        equal &= torch.equal(x, y)
        gap = max(gap, float((x.double() - y.double()).abs().max()))
    return equal, gap


def trainer_case(failures, smi, rates):
    """Phase 2k (iii): xlstm-125m whole through the ``Trainer``: a straight
    run of ``run_step`` calls; ``Trainer.run`` with checkpoints that fails
    at an injected step; a new Trainer that resumes from the last
    COMMITted step and finishes (the restore and its last save timed); the
    two end states compared (a second straight run gives the spread where they
    differ), and again with a planted fault (the resumed run one step
    behind, replaying a batch), which must part; one more step under
    ``torch.profiler``; the straight run's loss fall against
    ``TRAINER_FALL_GATE``, then the planted sign flip from its end.  Both
    fresh runs start from :func:`trainer_fan_in`."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_arch
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import InjectedFailure, Trainer, TrainLoopConfig
    cfg = get_config("xlstm-125m")
    arch = make_arch(cfg)
    opt = AdamWConfig(**TRAINER_OPT)
    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name, **kw):
        return Trainer(arch, opt, TrainLoopConfig(**{
            "total_steps": TRAINER_STEPS, "ckpt_every": TRAINER_CKPT_EVERY,
            "log_every": 1, "keep_ckpts": 1, "seed": SEED,
            "ckpt_dir": os.path.join(root, name)} | kw))

    def straight_run():
        tr = trainer("straight")
        trainer_fan_in(tr)
        return tr, [tr.run_step() for _ in range(TRAINER_STEPS)]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    straight, hist = straight_run()
    tree = straight._state_tree()
    nbytes = _weight_bytes(tree)
    failing = trainer("resumed", inject_failure_at=TRAINER_FAIL_AT)
    trainer_fan_in(failing)
    # the straight run's start: its batches' loss before it
    batches = range(TRAINER_STEPS)
    before = batches_loss(arch, failing.params, failing.data_cfg, batches)
    try:
        failing.run()
        failures.append("phase 2k (iii): the injected failure did not "
                        "raise")
    except InjectedFailure:
        failing.ckpt.wait()
    del failing
    resumed = trainer("resumed")
    t0 = time.time()
    resumed.try_resume()
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    saved = tree_map(lambda t: t.detach().clone(), resumed._state_tree(),
                     torch.is_tensor)
    t0 = time.time()
    rhist = resumed.run()
    # the run's last save (save_async, then wait): its time less its steps'
    save_s = time.time() - t0 - sum(h["step_seconds"] for h in rhist)
    peak = torch.cuda.max_memory_allocated()
    resumes = [e["step"] for e in resumed.events if e["kind"] == "resume"]
    if resumed.step != TRAINER_STEPS or resumes != \
            [TRAINER_FAIL_AT - TRAINER_FAIL_AT % TRAINER_CKPT_EVERY]:
        failures.append(f"phase 2k (iii): resumed at {resumes}, ended at "
                        f"step {resumed.step}")
    fall = before - batches_loss(arch, straight.params, straight.data_cfg,
                                 batches)
    equal, gap = _state_gap(tree, resumed._state_tree())
    spread = master_spread = None
    if not equal:
        again, _ = straight_run()
        _, spread = _state_gap(tree, again._state_tree())
        _, master_spread = _state_gap(tree["opt"]["master"],
                                      again.opt_state["master"])
        del again
        if gap > spread:
            failures.append(f"phase 2k (iii): resumed vs straight max |d| "
                            f"{gap} past two straight runs' {spread}")
    # the planted fault: the restored state resumed one step behind, read
    # on the f32 master weights (a bf16 param hides a step below its ulp)
    behind = trainer("behind")
    behind.params, behind.opt_state = saved["params"], saved["opt"]
    behind.step = resumes[0] - 1 if resumes else 0
    while behind.step < TRAINER_STEPS:
        behind.run_step()
    _, fault_gap = _state_gap(tree["opt"]["master"],
                              behind.opt_state["master"])
    if not fault_gap > (master_spread or 0.0):
        failures.append(f"phase 2k (iii): resumed one step behind, the end "
                        f"state is {fault_gap} from the straight run's")
    del behind, saved
    prof = lm_profiled(straight.run_step, "train_iii", 1)
    losses = [h["loss"] for h in hist]
    flip = flipped_fall(arch, opt, straight.params, straight.opt_state,
                        None, straight.data_cfg, straight.step)
    fall_checks(failures, "(iii)", fall, flip, TRAINER_FALL_GATE,
                TRAINER_STEPS)
    times = [h["step_seconds"] * 1e3 for h in hist]
    med = statistics.median(times)
    tokens = straight.data_cfg.global_batch * straight.data_cfg.seq_len
    work = train_work(cfg, straight.params, straight.opt_state, None, tokens)
    bound, by = train_bound_ms(work, rates)
    rec = {"arch": cfg.arch, "params": sum(
               t.numel() for t in _leaves(straight.params)),
           "steps": TRAINER_STEPS, "ckpt_every": TRAINER_CKPT_EVERY,
           "fail_at": TRAINER_FAIL_AT, "resumed_at": resumes,
           "tokens_per_step": tokens, "losses": losses,
           "batches_loss_before": before, "fall": fall,
           "flipped_fall": flip, "gate": TRAINER_FALL_GATE,
           "grad_norms": [h["grad_norm"] for h in hist],
           "resumed_bitwise": equal, "resumed_max_abs": gap,
           "straight_spread": spread, "one_step_behind_max_abs": fault_gap,
           "step_ms": times, "step_ms_median": med,
           "tokens_per_s": tokens / med * 1e3,
           "model_flops": work["flops"], "work": work, "bound_ms": bound,
           "bound_by": by, "share_of_bound": bound / med,
           "peak_gib": peak / 2**30, "trace": prof, "ckpt_bytes": nbytes,
           "ckpt_save_s": save_s, "ckpt_restore_s": restore_s}
    log(f"phase 2k (iii): {cfg.arch} whole, Trainer, {TRAINER_STEPS} "
        f"steps of {straight.data_cfg.global_batch}x"
        f"{straight.data_cfg.seq_len}: step {med:.1f} ms median "
        f"({min(times):.1f}-{max(times):.1f}), "
        f"{rec['tokens_per_s']:.0f} tokens/s; model {work['flops']:.4g} "
        f"FLOP, state {work['state_bytes'] / 1e9:.2f} GB -> bound "
        f"{bound:.3f} ms ({by}), {rec['share_of_bound']:.4f} of it; "
        f"{prof['kernels_per_call']:.0f} kernels per step, idle "
        f"{prof['idle_share']:.3f}; peak {rec['peak_gib']:.2f} GiB; "
        f"failure at {TRAINER_FAIL_AT}, resumed at {resumes}: end state "
        f"{'bitwise equal to' if equal else 'max |d| ' + str(gap) + ' from'}"
        f" the straight run's (two straight runs: {spread}); resumed one "
        f"step behind: master max |d| {fault_gap:.3g}; checkpoint "
        f"{nbytes / 1e9:.3f} GB saved in {save_s:.2f}s, restored in "
        f"{restore_s:.2f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}, on "
        f"the run's batches fell {fall:.4f} (gate {TRAINER_FALL_GATE}; sign "
        f"flipped: fell {flip:.4f}), grad norm {rec['grad_norms'][0]:.4g} -> "
        f"{rec['grad_norms'][-1]:.4g} (clip {opt.grad_clip}) | {smi}")
    del straight, resumed, tree
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def _check_errors(card, host, gates, stop_at=None) -> dict:
    """Each quantity's error, card (tensors on the card) against host
    (tensors on the host, moved over a leaf at a time), over its gate, in
    ``gates``' order; with ``stop_at``, stops after the first quantity
    whose ratio reaches it."""
    out = {}
    for q in gates:
        if q == "loss":
            err = abs(card[q] - host[q]) / abs(host[q])
        else:
            err = 0.0
            for c, h in zip(card[q], host[q]):
                h = h.to(c.device)
                if q == "update":
                    e = float(torch.linalg.vector_norm(c - h)
                              / torch.linalg.vector_norm(h))
                else:
                    e = float((c - h).abs().max() / h.abs().max())
                err = max(err, e)
                del h
        out[q] = err / gates[q]
        if stop_at is not None and out[q] >= stop_at:
            break
    return out


def _check_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-14b"), n_layers=1,
                               accum_steps=2)


def _check_params():
    """Case (iv)'s params on the card, in f32 (drawn in bf16 from the
    seed, as every case's are, then widened)."""
    from repro_torch.models.common import tree_map
    arch, p = _init_train(_check_cfg(), SEED + 12)
    return arch, tree_map(lambda t: t.float(), p, torch.is_tensor)


def _check_batch(device=None):
    from repro_torch.data import DataConfig, batch_for_step
    return batch_for_step(DataConfig(
        vocab=_check_cfg().vocab, seq_len=TRAIN_CHECK_SEQ,
        global_batch=TRAIN_CHECK_ROWS, seed=SEED + 11), 0, device)


def _check_run(arch, params, opt_cfg, batch, start_step=0):
    """Case (iv)'s step, ``grads_of`` then ``apply_updates`` (what
    ``make_train_step`` runs), from fresh optimizer state at
    ``start_step``; returns the quantities compared and the seconds of
    each part."""
    from repro_torch.models.common import tree_map
    from repro_torch.optim import apply_updates, init_opt_state
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    def sync():
        if batch["tokens"].is_cuda:
            torch.cuda.synchronize()

    old = tree_map(lambda t: t.detach().clone(), params, torch.is_tensor)
    st = init_opt_state(params, opt_cfg)
    st["step"].fill_(start_step)
    step = make_train_step(arch, opt_cfg, ShardCtx())
    sync()
    t0 = time.time()
    loss, _, grads = step.grads_of(params, batch)
    sync()
    t1 = time.time()
    params, st, met = apply_updates(params, grads, st, opt_cfg)
    sync()
    t2 = time.time()
    with torch.no_grad():
        for o, p in zip(_leaves(old), _leaves(params)):
            o.neg_().add_(p)              # new - old
    work = train_work(arch.cfg, params, st, None, batch["tokens"].numel())
    return {"work": work, "loss": float(loss), "grads": _leaves(grads),
            "m": _leaves(st["m"]), "v": _leaves(st["v"]),
            "update": _leaves(old), "grad_norm": float(met["grad_norm"]),
            "grads_s": t1 - t0, "update_s": t2 - t1}


def train_check_case(failures, smi, rates):
    """Phase 2k (iv): one full-width qwen3-14b layer with the full
    vocabulary in f32 (TF32 off), two microbatches: the step's grads
    (``make_train_step(...).grads_of``) and one AdamW update on the card
    against the same on the host's CPU from the same params, clean and
    with each planted fault (the clip not applied, one microbatch
    dropped, the bias correction one step off), each of which must read
    past the gate."""
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWConfig
    if torch.backends.cuda.matmul.allow_tf32:
        failures.append("phase 2k (iv): TF32 is on")
    opt = AdamWConfig(**TRAIN_CHECK_OPT)
    batch = _check_batch()
    t_case = time.time()
    arch, params = _check_params()
    host_params = tree_map(lambda t: t.to("cpu", copy=True), params,
                           torch.is_tensor)
    card = _check_run(arch, params, opt, batch)
    peak = torch.cuda.max_memory_allocated()
    del params
    t0 = time.time()
    host = _check_run(arch, host_params, opt, _check_batch("cpu"))
    host_s = time.time() - t0
    del host_params
    clean = _check_errors(card, host, TRAIN_CHECK_GATES)
    reading = max(clean.values())
    norms = [card["grad_norm"], host["grad_norm"]]
    card_s = {k: card[k] for k in ("grads_s", "update_s")}
    work = card["work"]
    bound, by = train_bound_ms(work, rates, "f32")
    if not reading <= 1.0:
        failures.append(f"phase 2k (iv): card vs host {clean} (each over "
                        f"its gate, {TRAIN_CHECK_GATES})")
    if not norms[1] > 2 * opt.grad_clip:
        failures.append(f"phase 2k (iv): grad norm {norms[1]} does not "
                        f"pass twice the clip {opt.grad_clip}")
    del card
    torch.cuda.empty_cache()

    def dropping(loss_fn):
        calls = []

        def loss(params, batch, cfg_, ctx_):
            total, metrics = loss_fn(params, batch, cfg_, ctx_)
            calls.append(1)
            return (total * 0.0 if len(calls) == 2 else total), metrics
        return loss

    faults = {
        "clip not applied": lambda a, p: _check_run(
            a, p, dataclasses.replace(opt, grad_clip=float("inf")), batch),
        "one microbatch dropped": lambda a, p: _check_run(
            dataclasses.replace(a, loss=dropping(a.loss)), p, opt, batch),
        "bias correction one step off": lambda a, p: _check_run(
            a, p, opt, batch, start_step=1),
    }
    fault_readings = {}
    for name, fn in faults.items():
        a, p = _check_params()
        got = fn(a, p)
        del p
        errs = _check_errors(got, host, TRAIN_CHECK_GATES, stop_at=2.0)
        fault_readings[name] = {"errors": errs,
                                "reading": max(errs.values())}
        if not max(errs.values()) > 1.0:
            failures.append(f"phase 2k (iv): planted fault '{name}' reads "
                            f"{errs}, within the gate")
        del got
        torch.cuda.empty_cache()
    rec = {"params": sum(t.numel() for t in host["grads"]),
           "rows": TRAIN_CHECK_ROWS, "seq": TRAIN_CHECK_SEQ,
           "model_flops": work["flops"], "work": work, "bound_ms": bound,
           "bound_by": by,
           "peak_gib": peak / 2**30,
           "accum_steps": _check_cfg().accum_steps,
           "gates": TRAIN_CHECK_GATES, "clean_errors": clean,
           "reading": reading, "faults": fault_readings,
           "grad_norm_card_host": norms, "card_s": card_s,
           "host_s": host_s, "host_grads_s": host["grads_s"],
           "host_update_s": host["update_s"],
           "seconds": time.time() - t_case}
    log(f"phase 2k (iv): qwen3-14b, one layer and the full vocabulary, "
        f"{rec['params'] / 1e9:.3f}e9 params in f32, "
        f"{TRAIN_CHECK_ROWS}x{TRAIN_CHECK_SEQ} tokens in 2 microbatches: "
        f"card vs host, each over its gate {TRAIN_CHECK_GATES}: "
        + ", ".join(f"{k} {v:.3g}" for k, v in clean.items())
        + f" (reading {reading:.3g}, limit 1); grad norm card "
        f"{norms[0]:.6g}, host {norms[1]:.6g} (clip {opt.grad_clip}); "
        "planted faults "
        + ", ".join(f"{k} {v['reading']:.3g}"
                    for k, v in fault_readings.items())
        + f" (each from its first quantity past 2); card step "
        f"{sum(card_s.values()) * 1e3:.0f} ms (grads "
        f"{card_s['grads_s'] * 1e3:.0f}, update "
        f"{card_s['update_s'] * 1e3:.0f}; one synchronized call, the first "
        f"at these shapes) against a bound of {bound:.1f} ms ({by}: "
        f"{work['flops']:.4g} FLOP at the f32 rate, "
        f"{work['state_bytes'] / 1e9:.1f} GB), peak "
        f"{rec['peak_gib']:.2f} GiB; "
        f"host {host_s:.1f}s (grads {host['grads_s']:.1f}s, "
        f"update {host['update_s']:.1f}s) | {smi}")
    del host
    return rec


def train_phase(failures, smi, hbm_bw, peak_bf16, peak_f32):
    """Phase 2k: LM training on the card (see the comment above
    ``TRAIN_SEQ``), one case at a time, each freed before the next.  It
    launches none of K1-K5.  Returns the record."""
    from repro_torch.kernels import engine as keng
    t_phase = time.time()
    rates = {"bytes": hbm_bw, "bf16": peak_bf16, "f32": peak_f32}
    before = dict(keng.LAUNCHES)
    rec = {"card": smi, "seconds_per_case": {}}
    for name, case in (("(i)", qwen3_train_case), ("(ii)", olmoe_train_case),
                       ("(iii)", trainer_case), ("(iv)", train_check_case)):
        t0 = time.time()
        torch.cuda.empty_cache()
        rec[name] = case(failures, smi, rates)
        rec["seconds_per_case"][name] = time.time() - t0
    launched = {k: keng.LAUNCHES[k] - before.get(k, 0)
                for k in keng.LAUNCHES if keng.LAUNCHES[k] != before.get(k)}
    if launched:
        failures.append(f"phase 2k launched kernels of ours: {launched}")
    rec["seconds"] = time.time() - t_phase
    log(f"phase 2k: {rec['seconds']:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s"
                    for k, v in rec["seconds_per_case"].items()) + ")")
    return rec

# phase 2l: the sharded LM paths (repro_torch.sharding: DTensors on a
# DeviceMesh; ROADMAP item 13d), eight ranks on the card over gloo, as 2i
# (NCCL refuses two ranks on one GPU): a (2, 4) ("data", "model") mesh,
# bf16, seeded weights at full width (the ranks: tests/_lm_chip.py, its
# CHIP sizes).  (i) qwen3-14b, depth cut to 8 of its 40 layers, TP-only
# params (serve_params_tp_only), wq/wk at their true fan-in
# (scale_scores, as 2j checks), prefill 4 x 256 then 8 teacher-forced
# decode steps, with decode_kv_seq_shard off and on (flash-decode over a
# KV cache whose sequence is sharded over "model"); (ii) qwen3-14b at 2
# layers, FSDP + TP, one AdamW step (f32 moments), its params saved as a
# checkpoint on (2, 4) and restored on (4, 2) and on (8, 1), the
# optimizer state re-meshed beside them, the whole state re-meshed onto
# (2, 4) and a second step; (iii) olmoe-1b-7b at 2 of 16 layers, prefill 4 x
# 256 with MoE dispatch "ep" and "local", and layer 0's MoE block alone
# on a seeded input.  The parent runs each case on one device first (the
# references); the ranks' results are held against them.
#
# Every gate sits 2x or more from its clean reading and from its planted
# fault's; on an H100 at 700 W (PERF.md, phase 2l), clean / fault:
# serving's max |logit| gap 0.1172 (dense) and 0.1133 (flash) / 2.590
# and 2.578 (the last decode step run again one cache slot late), flash
# vs dense 0.08594.  Training, per leaf (the worst leaf), as the gap's
# norm over the reference's: the f32 master's change 0.1957 (Adam's
# first step is lr * sign(g), and entries whose g cancels to bf16 noise
# flip) / 0.9996 with one dp rank's gradient lost (one device's step on
# dp rank 0's rows, its grads halved) and 2.000 with the update's sign
# flipped; the first moment 0.02986 / 0.8880; the second step's loss
# 2.861e-5 / 3.681e-4 with the first update skipped; the first loss
# keeps the reference tests' 5e-3 (1.38e-4).  MoE: layer 0's block, max
# |gap| over its largest output, 0 (bitwise) / 0.5138 with expert 0's
# output dropped; the logits (gate 0.125) read one bf16 ulp, 0.03125,
# and do not see that fault.
LM2L_GATES = {"serve": 0.5, "flash_vs_dense": 0.25, "loss1": 5e-3,
              "master": 0.45, "m": 0.1, "loss2": 1e-4, "moe": 0.125,
              "moe_layer": 0.05}


def sharded_phase(failures, smi):
    """Phase 2l (see the comment above ``LM2L_GATES``).  It launches none
    of K1-K5.  Returns the record."""
    import numpy as np
    from repro_torch.models import make_arch
    from repro_torch.models.common import (init_params, scale_scores,
                                           tree_leaves, tree_map)
    from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    world, dist_world = load_helper("_lm_chip"), load_helper("_dist_world")
    t_phase = time.time()
    out_dir = os.path.join(ROOT, "build", "dist2l")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(os.path.join(out_dir, "train"))
    scfg, tcfg, mcfg = world.chip_cfgs()
    C = world.CHIP
    ctx = ShardCtx()
    p = C["prompt"]

    def tokens(cfg, rows, n, salt=0):
        return torch.from_numpy(world.chip_tokens(cfg.vocab, rows, n,
                                                  salt)).cuda()
    # (i) the single-device serving run
    arch = make_arch(scfg)
    specs = arch.param_specs(scfg)
    params = init_params(torch.Generator("cuda").manual_seed(
        C["serve_seed"]), specs)
    scale_scores(params, specs)
    toks = tokens(scfg, C["rows"], p + C["decode"])
    with torch.inference_mode():
        st, n, lg = arch.prefill(params, {"tokens": toks[:, :p]}, scfg, ctx,
                                 max_len=C["max_len"])
        logits = [lg[:, -1].float().cpu()]
        for i in range(C["decode"]):
            st, n, lg = arch.decode(params, st, n, toks[:, p + i:p + i + 1],
                                    scfg, ctx)
            logits.append(lg[:, -1].float().cpu())
    ref_serve = torch.stack(logits, 1).numpy()
    del params, st, lg
    torch.cuda.empty_cache()
    # (ii) two single-device steps; the first's change of the f32 master
    # and its first moment, to files (bfloat16 bits)
    arch = make_arch(tcfg)
    specs = arch.param_specs(tcfg)
    opt = AdamWConfig(**world.CHIP_OPT)
    step = make_train_step(arch, opt, ctx)
    batches = [{"tokens": tokens(tcfg, C["train_rows"], C["train_seq"],
                                 salt=k)} for k in (1, 2)]

    def fresh():
        p = init_params(torch.Generator("cuda").manual_seed(
            C["train_seed"]), specs)
        return p, init_opt_state(p, opt), [
            t.clone() for t in tree_leaves(p, torch.is_tensor)]
    params, state, init = fresh()
    params, state, met1 = step(params, state, batches[0])
    for i, (p0, ma, m) in enumerate(zip(
            init, tree_leaves(state["master"], torch.is_tensor),
            tree_leaves(state["m"], torch.is_tensor))):
        np.save(os.path.join(out_dir, "train", f"d{i}.npy"),
                world.bf16_bits(ma - p0.float()))
        np.save(os.path.join(out_dir, "train", f"m{i}.npy"),
                world.bf16_bits(m))
    del init
    _, _, met2 = step(params, state, batches[1])
    ref_train = {"loss1": float(met1["loss"]), "loss2": float(met2["loss"])}
    del params, state
    torch.cuda.empty_cache()
    # the planted faults, on one device: the second batch's loss with the
    # first update skipped, and the first step with one dp rank's gradient
    # lost (the rows of dp rank 0 alone; their mean-loss grads halved, as
    # a sum over dp of per-rank shares of the whole batch's mean leaves
    # them)
    params, state, init = fresh()
    with torch.no_grad():
        ref_train["loss2_skipped"] = float(arch.loss(
            params, batches[1], tcfg, ctx)[0])
    _, _, grads = step.grads_of(params, {
        "tokens": batches[0]["tokens"][:C["train_rows"] // 2]})
    apply_updates(params, tree_map(lambda g: g * 0.5, grads,
                                   torch.is_tensor), state, opt)
    del grads
    lost = []
    for i, (p0, ma, m) in enumerate(zip(
            init, tree_leaves(state["master"], torch.is_tensor),
            tree_leaves(state["m"], torch.is_tensor))):
        ref = [world.from_bf16_bits(np.load(os.path.join(
            out_dir, "train", f"{k}{i}.npy")), "cuda") for k in ("d", "m")]
        sums, maxes = world.step_sums(ma - p0.float(), ref[0], m, ref[1])
        lost.append(world.step_gaps(sums.tolist(), maxes.tolist()))
    del params, state, init, step, ref
    torch.cuda.empty_cache()
    # (iii) the single-device MoE prefill
    arch = make_arch(mcfg)
    params = init_params(torch.Generator("cuda").manual_seed(
        C["moe_seed"]), arch.param_specs(mcfg))
    moe_toks = tokens(mcfg, C["rows"], p, salt=3)
    with torch.inference_mode():
        _, _, lg = arch.prefill(params, {"tokens": moe_toks}, mcfg, ctx,
                                max_len=p)
    ref_moe = lg[:, -1].float().cpu().numpy()
    ref_moe_layer = world.moe_layer(params, torch.from_numpy(
        world.moe_layer_input(mcfg)).to("cuda", torch.bfloat16), mcfg, ctx)
    ref_moe_layer = ref_moe_layer.float().cpu().numpy()
    del params, lg
    torch.cuda.empty_cache()
    t_ref = time.time() - t_phase
    log(f"phase 2l: single-device references in {t_ref:.1f}s "
        f"({scfg.arch} {scfg.n_layers} of 40 layers serving, "
        f"{tcfg.n_layers} layers training, {mcfg.arch} {mcfg.n_layers} "
        f"layers; depth cut to fit the phase's time, widths published)")
    t0 = time.time()
    ranks = dist_world.run_world(
        "chip", 8, out_dir, device="cuda", timeout=900, script=world.SCRIPT,
        env=dict(os.environ,
                 PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    t_world = time.time() - t0
    rec = {"card": smi, "reference_s": t_ref, "world_s": t_world,
           "gates": LM2L_GATES, "ranks": [r["chip"] for r in ranks]}
    for r in ranks:
        for name, (ok, detail) in r["checks"].items():
            if not ok:
                failures.append(f"phase 2l rank {r['rank']} {name}: "
                                f"{detail}")

    def gap(a, b):
        return float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
    got = {k: np.load(os.path.join(out_dir, f"serve_{k}.npy"))
           for k in ("dense", "flash")}
    fault = {k: np.load(os.path.join(out_dir, f"serve_{k}_fault.npy"))
             for k in ("dense", "flash")}
    g = LM2L_GATES
    serve = {k: [gap(got[k][:, i], ref_serve[:, i])
                 for i in range(ref_serve.shape[1])] for k in got}
    serve["fault"] = {k: gap(fault[k], ref_serve[:, -1]) for k in fault}
    serve["flash_vs_dense"] = gap(got["flash"], got["dense"])
    rec["serve_gaps"] = serve
    for k in ("dense", "flash"):
        if max(serve[k]) > g["serve"]:
            failures.append(f"phase 2l (i) {k}: logits part from one "
                            f"device by {max(serve[k]):.4g} > {g['serve']}")
        if serve["fault"][k] <= 2 * g["serve"]:
            failures.append(f"phase 2l (i) {k}: the planted fault reads "
                            f"{serve['fault'][k]:.4g}, not above 2x the "
                            f"gate {g['serve']}")
    if serve["flash_vs_dense"] > g["flash_vs_dense"]:
        failures.append(f"phase 2l (i): flash vs dense on the mesh "
                        f"{serve['flash_vs_dense']:.4g} > "
                        f"{g['flash_vs_dense']}")
    tr = [r["chip"]["training"] for r in ranks]

    def worst(gaps, key):
        return max(x[key] for x in gaps)
    mesh_gaps = tr[0]["step_gaps"]
    train = {"loss1": abs(tr[0]["loss1"] - ref_train["loss1"]),
             "loss2": abs(tr[0]["loss2"] - ref_train["loss2"]),
             "reference": ref_train,
             "loss2_skipped": abs(ref_train["loss2_skipped"]
                                  - ref_train["loss2"])}
    for key in ("delta_rel", "m_rel", "delta_max_rel", "m_max_rel",
                "flipped_rel"):
        train[key] = worst(mesh_gaps, key)
        train[f"dp_lost_{key}"] = worst(lost, key)
    rec["train_gaps"] = train
    for k in ("loss1", "loss2"):
        if not train[k] <= g[k]:
            failures.append(f"phase 2l (ii) {k}: {train[k]:.4g} > {g[k]}")
    for k, gate in (("delta_rel", g["master"]), ("m_rel", g["m"])):
        if not train[k] <= gate:
            failures.append(f"phase 2l (ii) {k}: {train[k]:.4g} > {gate}")
    # the planted faults, each read 2x or more past its gate
    for k, gate in (("loss2_skipped", g["loss2"]),
                    ("flipped_rel", g["master"]),
                    ("dp_lost_delta_rel", g["master"]),
                    ("dp_lost_m_rel", g["m"])):
        if not train[k] > 2 * gate:
            failures.append(f"phase 2l (ii): the planted fault {k} reads "
                            f"{train[k]:.4g}, not above 2x the gate {gate}")

    moe = {k: gap(np.load(os.path.join(out_dir, f"moe_{k}.npy")), ref_moe)
           for k in ("ep", "local")}
    moe["ep_vs_local"] = gap(np.load(os.path.join(out_dir, "moe_ep.npy")),
                             np.load(os.path.join(out_dir, "moe_local.npy")))
    top = float(np.abs(ref_moe_layer).max())
    for k in ("ep", "local", "fault"):
        y = world.from_bf16_bits(np.load(os.path.join(
            out_dir, f"moe_layer_{k}.npy")), "cpu").numpy()
        moe[f"layer_{k}"] = gap(y, ref_moe_layer) / top
    rec["moe_gaps"] = moe
    for k, gate in (("ep", g["moe"]), ("local", g["moe"]),
                    ("layer_ep", g["moe_layer"]),
                    ("layer_local", g["moe_layer"])):
        if moe[k] > gate:
            failures.append(f"phase 2l (iii) {k}: {moe[k]:.4g} > {gate}")
    if not moe["layer_fault"] > 2 * g["moe_layer"]:
        failures.append(f"phase 2l (iii): the planted fault (expert "
                        f"{C['moe_fault_expert']} dropped) reads "
                        f"{moe['layer_fault']:.4g}, not above 2x the gate "
                        f"{g['moe_layer']}")
    # what each rank reports
    for r in ranks:
        c = r["chip"]
        sv, t2, m = c["serving"], c["training"], c["moe"]
        log(f"  2l rank {r['rank']}: (i) dense prefill "
            f"{sv['dense']['prefill_ms']:.1f} ms, decode "
            f"{statistics.median(sv['dense']['decode_ms']):.1f} ms/step "
            f"(collectives {sv['dense']['decode_collective_share']:.2f}); "
            f"flash prefill {sv['flash']['prefill_ms']:.1f} ms, decode "
            f"{statistics.median(sv['flash']['decode_ms']):.1f} ms/step "
            f"(collectives {sv['flash']['decode_collective_share']:.2f}), "
            f"peak {sv['peak_gib']:.2f} GiB; (ii) step "
            f"{t2['step_ms']:.1f} ms (collectives "
            f"{t2['step_collective_share']:.2f}), params checkpoint "
            f"{t2['ckpt_bytes'] / 1e9:.2f} GB saved in {t2['save_s']:.1f} "
            f"s, restored on (4, 2) in {t2['restore_4x2_s']:.1f} s, (8, 1) "
            f"{t2['restore_8x1_s']:.1f} s, optimizer state onto (8, 1) "
            f"{t2['remesh_opt_s']:.1f} s, all onto (2, 4) "
            f"{t2['remesh_s']:.1f} s, "
            f"step 2 {t2['step2_ms']:.1f} ms, peak {t2['peak_gib']:.2f} "
            f"GiB; (iii) prefill ep {m['ep']['prefill_ms']:.1f} ms "
            f"(collectives {m['ep']['collective_share']:.2f}), local "
            f"{m['local']['prefill_ms']:.1f} ms | launches {c['launches']}")
    log(f"phase 2l (i): logits vs one device per step, dense "
        f"{[round(x, 4) for x in serve['dense']]}, flash "
        f"{[round(x, 4) for x in serve['flash']]} (gate {g['serve']}); "
        f"planted fault {serve['fault']}; flash vs dense on the mesh "
        f"{serve['flash_vs_dense']:.4g} (gate {g['flash_vs_dense']}) | "
        f"card {smi}")
    log(f"phase 2l (ii): loss {tr[0]['loss1']:.5f} vs {ref_train['loss1']:.5f}"
        f" on one device; per leaf, worst of the f32 master's change "
        f"|d| / |ref| {train['delta_rel']:.4g} (gate {g['master']}; max "
        f"entry {train['delta_max_rel']:.4g} of the largest), first moment "
        f"{train['m_rel']:.4g} (gate {g['m']}; max entry "
        f"{train['m_max_rel']:.4g}); planted faults: update's sign flipped "
        f"{train['flipped_rel']:.4g}, one dp rank's gradient lost "
        f"{train['dp_lost_delta_rel']:.4g} / {train['dp_lost_m_rel']:.4g} "
        f"(max entry {train['dp_lost_delta_max_rel']:.4g} / "
        f"{train['dp_lost_m_max_rel']:.4g}); state "
        f"{tr[0]['state_bytes'] / 1e9:.2f} GB on 8 ranks; after restore "
        f"and remesh, step 2 loss {tr[0]['loss2']:.5f} vs "
        f"{ref_train['loss2']:.5f} (gap {train['loss2']:.4g}, gate "
        f"{g['loss2']}; the first update skipped: "
        f"{train['loss2_skipped']:.4g}) | card {smi}")
    log(f"phase 2l (iii): {mcfg.arch} logits vs one device: ep "
        f"{moe['ep']:.4g}, local {moe['local']:.4g}, ep vs local "
        f"{moe['ep_vs_local']:.4g} (gate {g['moe']}); layer 0's MoE block "
        f"vs one device, max |gap| over its largest output: ep "
        f"{moe['layer_ep']:.4g}, local {moe['layer_local']:.4g} (gate "
        f"{g['moe_layer']}), planted fault (expert "
        f"{C['moe_fault_expert']}'s output dropped) "
        f"{moe['layer_fault']:.4g} | card {smi}")
    shutil.rmtree(out_dir, ignore_errors=True)
    rec["seconds"] = time.time() - t_phase
    log(f"phase 2l: {rec['seconds']:.1f}s (references {t_ref:.1f}s, 8 ranks"
        f" {t_world:.1f}s)")
    return rec


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

    # ---- phase 2j: LM serving, qwen3-14b at full width and depth ---------
    torch.cuda.empty_cache()
    lm = lm_phase(failures, smi, hbm_bw, peak_bf16_tc, peak_f32)
    if failures:
        raise SystemExit("phase 2j failed:\n" + "\n".join(failures))

    # ---- phase 2k: LM training, qwen3-14b and olmoe-1b-7b at full width -
    torch.cuda.empty_cache()
    train = train_phase(failures, smi, hbm_bw, peak_bf16_tc, peak_f32)
    if failures:
        raise SystemExit("phase 2k failed:\n" + "\n".join(failures))

    # ---- phase 2l: the sharded LM paths, eight ranks on the card ---------
    torch.cuda.empty_cache()
    sharded = sharded_phase(failures, smi)
    if failures:
        raise SystemExit("phase 2l failed:\n" + "\n".join(failures[:40]))

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
                   "lm_serving": lm, "lm_training": train,
                   "lm_sharded": sharded,
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
