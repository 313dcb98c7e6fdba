"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels K1-K4 from ``src/repro_torch/kernels/csrc``
(nvcc, into ``build/repro_torch/``), then:

1. holds each kernel against its plain PyTorch version on the card —
   every paper stencil (plus forced-dense blur2d/star33_3d) and every
   paper pipeline x 4 boundaries x f64/f32/bf16 x sweeps {1,2,4}, odd
   shapes, both kernels per case (K1/K2 for a spec, K3/K4 for a
   pipeline): f64 bitwise, f32 within 1e-5, bf16 equal or within one
   bf16 ulp; plus the fuzz regression corpus's chains (ranks 1-3), a
   mixed zero/constant/reflect chain, tiny grids, a periodic grid above
   the whole-grid budget and batched grids;
2. runs the engine — ``CasperEngine(spec, backend="cuda",
   sweeps=4).run(grid, iters=10)``, all f64, each bitwise equal to
   ``backend="ref"`` on the card, on two main paths, each with the launch
   counts reset just before it and read just after:
   (a) single specs at each paper stencil's Table 3 DRAM shape (zero and
   periodic boundary) and at jacobi2d 8192^2 and heat3d 512x512x256
   (K1, K2); (b) pipelines: reaction_diffusion2d at 2048^2 and 8192^2,
   advect_diffuse2d at 1024^2 and 2048^2 (above the periodic whole-grid
   budget), the mixed chain at 2048^2 (K3, K4) and a chain that cannot
   fuse at 2048^2 (staged: K1 per stage);
3. times one fused block per phase-2 case with CUDA events (median),
   beside its bytes bound, the plain version, chained ``F.conv`` (the
   yardstick, never used by the port) and, for pipelines, the staged
   chain of the port's own K1 launches.

Prints the card's name and power limit and a ``{"kernels": [...]}`` line
before the last line, which is ``{"ok": true, "device": {...}}``.  Full
results go to ``build/chip_smoke.json``.  Exits non-zero, printing
no result, when CUDA is missing or any check fails.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
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
}
SOURCE = "src/repro_torch/kernels/csrc/stencil.cu"

# Data-sheet rates by card (NVIDIA H100/H200 data sheets): HBM bytes/s
# and f64 FLOP/s outside the tensor cores.
CARD_RATES = {
    "H100 PCIe": (2.0e12, 25.6e12),
    "H100 NVL": (3.9e12, 30e12),
    "H200": (4.8e12, 34e12),
    "H100": (3.35e12, 34e12),               # SXM
}


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


def randn(shape, dtype, gen):
    return torch.randn(shape, dtype=torch.float64, device="cuda",
                       generator=gen).to(dtype)


def within_bf16_ulp(got, want) -> bool:
    """Every element equal, or one bf16 ulp of ``want`` apart."""
    g, w = got.double(), want.double()
    mag = w.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((g - w).abs() <= ulp).all())


def conv_chain(spec, sweeps):
    """The yardstick: ``sweeps`` applications of the spec's stage chain
    as chained F.conv{1,2,3}d, each on an F.pad in its stage's mode
    (cuDNN, TF32 off).  Returns ``grid -> result``."""
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
        x = grid.reshape((1, 1) + tuple(grid.shape))
        for _ in range(sweeps):
            for w, pads, mode, value in steps:
                if mode == "constant":
                    xp = F.pad(x, pads, mode="constant", value=value)
                else:
                    xp = F.pad(x, pads, mode=mode)
                x = conv(xp, w.to(x.dtype))
        return x.reshape(grid.shape)
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.time()
    from repro_torch import (CasperEngine, DOMAIN_SIZES, PAPER_PIPELINES,
                             PAPER_STENCILS, StencilPipeline)
    from repro_torch.core import plan as tplan
    from repro_torch.core import ref as tref
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine as keng
    # the fuzz corpus's chains (by path: a site package may own `tests`)
    cases_path = os.path.join(ROOT, "tests", "_pipeline_cases.py")
    loader = importlib.util.spec_from_file_location("_pipeline_cases",
                                                    cases_path)
    pipeline_cases = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(pipeline_cases)
    REGRESSION_CORPUS = pipeline_cases.REGRESSION_CORPUS
    random_pipeline = pipeline_cases.random_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    rate_key, (hbm_bw, peak_f64) = card_rates(name)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | rates of {rate_key}: {hbm_bw:.3g} B/s, f64 {peak_f64:.3g}")

    # ---- setup: build every kernel source from the checkout -------------
    t0 = time.time()
    paths = _build.build_all()
    log(f"build: {time.time() - t0:.1f}s -> {[str(p) for p in paths.values()]}")
    for src, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    max_err = {k: 0.0 for k in REPLACES}
    failures = []

    def is_pipe(spec):
        return isinstance(spec, StencilPipeline)

    def compare(kernel, got, want, dtype, label):
        err = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0.0
        max_err[kernel] = max(max_err[kernel], err)
        if dtype == torch.float64:
            ok = torch.equal(got, want)
        elif dtype == torch.float32:
            ok = err <= F32_ATOL
        else:
            ok = within_bf16_ulp(got, want)
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

    def run_kernel(spec, grid, sweeps, strategy, label, dtype):
        before = dict(keng.LAUNCHES)
        sweep = keng.pipeline_sweep if is_pipe(spec) else keng.stencil_sweep
        got = sweep(spec, grid, sweeps=sweeps, strategy=strategy)
        torch.cuda.synchronize()
        ran = [k for k in keng.LAUNCHES if keng.LAUNCHES[k] != before[k]]
        if len(ran) != 1:
            failures.append(f"{label}: launched {ran}")
            return None
        tile = tplan.default_tile(spec, sweeps, grid.element_size())
        if strategy is None:
            strategy = tplan.ghost_strategy_for(
                spec, grid.shape[-spec.ndim:], grid.element_size(), sweeps,
                tile)
        compare(ran[0], got, plain_block(spec, grid, tile, sweeps,
                                         strategy)(), dtype, label)
        return ran[0]

    # ---- phase 1: each kernel vs its plain version ----------------------
    t0 = time.time()
    odd = {1: (10007,), 2: (77, 301), 3: (37, 45, 101)}
    specs = [(n, s) for n, s in PAPER_STENCILS.items()]
    specs += [(f"{n}-dense", PAPER_STENCILS[n].with_structure("dense"))
              for n in ("blur2d", "star33_3d")]
    specs += [(n, p) for n, p in PAPER_PIPELINES.items()]
    n_cases = 0
    keng.reset_launches()
    for label, spec0 in specs:
        for boundary in BOUNDARIES:
            spec = spec0.with_boundary(boundary)
            for dtype in DTYPES:
                g = randn(odd[spec.ndim], dtype, gen)
                for sweeps in (1, 2, 4):
                    for strategy in ("pad-free", "padded-window"):
                        run_kernel(spec, g, sweeps, strategy,
                                   f"{label} {boundary} {dtype} s{sweeps}",
                                   dtype)
                        n_cases += 1
    rd = PAPER_PIPELINES["reaction_diffusion2d"]
    mixed = StencilPipeline("mixed_rd", (
        rd.stages[0].with_boundary("zero"),
        rd.stages[1].with_boundary("constant(0.75)"),
        rd.stages[0].with_boundary("reflect")))
    chains = [(f"corpus seed {c[0]}", random_pipeline(*c[:4]), c[4])
              for c in REGRESSION_CORPUS]
    for label, pipe, sweeps in chains + [("mixed_rd", mixed, 1),
                                         ("mixed_rd", mixed, 2),
                                         ("mixed_rd", mixed, 4)]:
        for dtype in DTYPES:
            g = randn(odd[pipe.ndim], dtype, gen)
            for strategy in ("pad-free", "padded-window"):
                run_kernel(pipe, g, sweeps, strategy,
                           f"{label} {dtype} s{sweeps}", dtype)
                n_cases += 1
    log(f"phase 1: {n_cases} kernel-vs-plain cases on odd shapes "
        f"{list(odd.values())}, launches {dict(keng.LAUNCHES)}, max |err| "
        f"{max_err} ({time.time() - t0:.1f}s)")
    tiny = {1: (5,), 2: (3, 7), 3: (2, 3, 5)}
    extra = [(f"tiny {n}", PAPER_STENCILS[n].with_boundary(b), tiny[
        PAPER_STENCILS[n].ndim], 1, 4)
        for n in ("7pt1d", "blur2d", "star33_3d") for b in BOUNDARIES]
    extra += [(f"tiny {n}", p.with_boundary(b), tiny[2], 1, 4)
              for n, p in PAPER_PIPELINES.items() for b in BOUNDARIES]
    extra.append(("periodic over budget jacobi2d",
                  PAPER_STENCILS["jacobi2d"].with_boundary("periodic"),
                  (2048, 2048), 1, 4))
    extra += [(f"batched {n}", PAPER_STENCILS[n].with_boundary("reflect"),
               odd[PAPER_STENCILS[n].ndim], 3, 4)
              for n in ("jacobi1d", "jacobi2d", "heat3d")]
    extra += [("batched mixed_rd", mixed, odd[2], 3, 4),
              ("batched advect_diffuse2d", PAPER_PIPELINES[
                  "advect_diffuse2d"], odd[2], 3, 4)]
    for label, spec, shape, batch, sweeps in extra:
        shape = (batch,) + shape if batch > 1 else shape
        g = randn(shape, torch.float64, gen)
        kernel = run_kernel(spec, g, sweeps, None, label, torch.float64)
        log(f"  {label} {shape} s{sweeps}: plan chose "
            f"{kernel}, equal to plain: "
            f"{not any(f.startswith(label) for f in failures)}")
    if failures:
        raise SystemExit("phase 1 failed:\n" + "\n".join(failures[:40]))

    # ---- phase 2: the engine, counted per main path -----------------------
    def drive(cases, label):
        """Run each case's engine once with the counts reset just before
        and read just after; then hold each result against
        ``backend="ref"`` on the card."""
        grids = [randn(shape, torch.float64, gen) for _, _, shape, _ in cases]
        engines = [CasperEngine(spec, backend="cuda", sweeps=4)
                   for _, spec, _, _ in cases]
        torch.cuda.synchronize()
        t0 = time.time()
        keng.reset_launches()
        outs, per_run = [], []
        for eng, g in zip(engines, grids):
            before = dict(keng.LAUNCHES)
            outs.append(eng.run(g, iters=10))
            per_run.append({k: keng.LAUNCHES[k] - before[k]
                            for k in keng.LAUNCHES
                            if keng.LAUNCHES[k] != before[k]})
        torch.cuda.synchronize()
        launches = dict(keng.LAUNCHES)
        log(f"phase 2{label}: engine.run(iters=10, sweeps=4) on {len(cases)} "
            f"grids in {time.time() - t0:.2f}s; launches {launches}")
        results = []
        for (n, spec, shape, level), g, out, k in zip(cases, grids, outs,
                                                      per_run):
            want = CasperEngine(spec, backend="ref").run(g, iters=10)
            equal = torch.equal(out, want)
            finite = bool(torch.isfinite(out).all())
            boundary = getattr(spec, "boundary", None) or "+".join(
                s.boundary for s in spec.stages)
            if not (equal and finite and tuple(out.shape) == tuple(shape)):
                failures.append(f"phase 2{label} {n} {boundary} {shape}: "
                                f"equal {equal} finite {finite}")
            results.append({"stencil": n, "boundary": boundary,
                            "shape": list(shape), "level": level,
                            "bitwise_equal_ref": equal,
                            "launches_per_run": k})
            del want
        del outs
        log(f"phase 2{label}: {sum(r['bitwise_equal_ref'] for r in results)}"
            f"/{len(results)} bitwise equal to backend='ref' on the card")
        return grids, engines, results, launches

    cases = []
    for n, spec in PAPER_STENCILS.items():
        shape = DOMAIN_SIZES["DRAM"][spec.ndim]
        cases.append((n, spec, shape, "DRAM"))
        cases.append((n, spec.with_boundary("periodic"), shape, "DRAM"))
    cases.append(("jacobi2d", PAPER_STENCILS["jacobi2d"], (8192, 8192),
                  "HBM"))
    cases.append(("heat3d", PAPER_STENCILS["heat3d"], (512, 512, 256),
                  "HBM"))
    grids, engines, results, launches = drive(cases, "a")
    if min(launches[k] for k in ("K1", "K2")) < 1:
        raise SystemExit(f"phase 2a: a kernel of the path never ran: "
                         f"{launches}")
    nonfusable = StencilPipeline("advect_react", (
        PAPER_PIPELINES["advect_diffuse2d"].stages[0], rd.stages[1]))
    ad = PAPER_PIPELINES["advect_diffuse2d"]
    pcases = [("reaction_diffusion2d", rd, (2048, 2048), "DRAM"),
              ("reaction_diffusion2d", rd, (8192, 8192), "HBM"),
              ("advect_diffuse2d", ad, (2048, 2048), "DRAM"),
              ("advect_diffuse2d", ad, (1024, 1024), "L3"),
              ("mixed_rd", mixed, (2048, 2048), "DRAM"),
              ("advect_react", nonfusable, (2048, 2048), "DRAM")]
    pgrids, pengines, presults, plaunches = drive(pcases, "b")
    if min(plaunches[k] for k in ("K1", "K3", "K4")) < 1:
        raise SystemExit(f"phase 2b: a kernel of the path never ran: "
                         f"{plaunches}")
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

    # ---- phase 3: times ---------------------------------------------------
    def kernel_of(plan):
        if not plan.fused:
            return "staged"
        return {(False, "pad-free"): "K1", (False, "padded-window"): "K2",
                (True, "pad-free"): "K3", (True, "padded-window"): "K4"}[
                    (plan.is_pipeline, plan.ghost_strategy)]

    log("phase 3: one fused block (sweeps=4) per case, median of CUDA "
        f"events | card {smi}")
    log(f"  {'stencil':20s} {'shape':16s} {'kern':6s} {'ms':>8s} "
        f"{'GB/s':>7s} {'bound':>7s} {'plain':>8s} {'conv':>8s} "
        f"{'staged':>8s}")
    for r, (n, spec, shape, level), g, eng in (
            list(zip(results, cases, grids, engines))
            + list(zip(presults, pcases, pgrids, pengines))):
        plan = eng.plan_for(shape, g.dtype)
        kernel = kernel_of(plan)
        reps = 20 if level == "HBM" else 50
        ms = time_ms(lambda: tplan.execute(plan, g), reps)
        if is_pipe(spec):
            traffic = keng.hbm_pipeline_traffic(spec, shape, plan.tile, 4, 8)
        else:
            traffic = keng.hbm_traffic(spec, shape, plan.tile, 4, 8)
        bound = 2 * math.prod(shape) * 8 / hbm_bw * 1e3
        ops = math.prod(shape) * 4 * spec.structured_flops_per_point()
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
                 ops_ms=ops / peak_f64 * 1e3, plain_ms=plain_ms,
                 library_ms=lib, staged_ms=staged_ms)
        log(f"  {n + ' ' + r['boundary'][:9]:20s} {str(tuple(shape)):16s} "
            f"{kernel:6s} {ms:8.4f} {r['gbps']:7.1f} {bound:7.4f} "
            f"{plain_ms:8.2f} {lib:8.3f} "
            f"{'' if staged_ms is None else f'{staged_ms:8.4f}'}")
    if failures:
        raise SystemExit("phase 3 failed:\n" + "\n".join(failures))

    # ---- the kernels line: one representative main-path case each ------
    def kernel_entry(kname, spec, g, window_call, count):
        nd = spec.ndim
        shape = tuple(g.shape)
        sweeps = 4
        tile = tplan.default_tile(spec, sweeps, 8)
        wide = tuple(sweeps * h for h in spec.halo)
        if window_call:
            src = tref.pad_boundary(g, wide, spec.boundary_mode,
                                    spec.boundary_value)
            fn = (keng.pipeline_window_sweep if is_pipe(spec)
                  else keng.stencil_window_sweep)
            pfn = (keng.pipeline_window_sweep_plain if is_pipe(spec)
                   else keng.stencil_window_sweep_plain)

            def kern():
                return fn(spec, src, shape, (0,) * nd, shape, tile, sweeps)

            def plain():
                return pfn(spec, src, shape, (0,) * nd, shape, tile, sweeps)
        else:
            src = g
            fn = keng.pipeline_sweep if is_pipe(spec) else keng.stencil_sweep

            def kern():
                return fn(spec, g, tile, sweeps, "pad-free")

            plain = plain_block(spec, g, tile, sweeps, "pad-free")
        nbytes = (src.numel() + g.numel()) * 8
        ops = g.numel() * sweeps * spec.structured_flops_per_point()
        t_bytes, t_ops = nbytes / hbm_bw * 1e3, ops / peak_f64 * 1e3
        compare(kname, kern(), plain(), torch.float64, f"kernels {kname}")
        lib = conv_chain(spec, sweeps)
        entry = {
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": count[kname],
            "max_abs_err": max_err[kname],
            "ms": time_ms(kern, 20),
            "plain_ms": time_ms(plain, 3, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lambda: lib(g), 5),
            "shape": list(shape), "spec": spec.name,
            "boundary": getattr(spec, "boundary", None)
            or "+".join(s.boundary for s in spec.stages),
            "sweeps": sweeps, "dtype": "float64",
        }
        torch.cuda.empty_cache()
        return entry

    def grid_of(gs, cs, n, boundary, shape):
        return gs[[i for i, c in enumerate(cs)
                   if c[0] == n and tuple(c[2]) == shape
                   and getattr(c[1], "boundary_mode", None) == boundary][0]]

    kernels = [
        kernel_entry("K1", PAPER_STENCILS["jacobi2d"],
                     grid_of(grids, cases, "jacobi2d", "zero", (8192, 8192)),
                     False, launches),
        kernel_entry("K2", PAPER_STENCILS["jacobi2d"].with_boundary(
            "periodic"), grid_of(grids, cases, "jacobi2d", "periodic",
                                 (2048, 2048)), True, launches),
        kernel_entry("K3", rd, grid_of(pgrids, pcases, "reaction_diffusion2d",
                                       "reflect", (8192, 8192)),
                     False, plaunches),
        kernel_entry("K4", ad, grid_of(pgrids, pcases, "advect_diffuse2d",
                                       "periodic", (2048, 2048)),
                     True, plaunches),
    ]
    if failures:
        raise SystemExit("kernels line failed:\n" + "\n".join(failures))

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "rates_of": rate_key,
                   "hbm_bw": hbm_bw, "peak_f64": peak_f64,
                   "phase1_cases": n_cases, "launches": launches,
                   "pipeline_launches": plaunches, "cases": results,
                   "pipeline_cases": presults, "kernels": kernels,
                   "seconds": time.time() - t_start}, fh, indent=1)
    log(f"total {time.time() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
