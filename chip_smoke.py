"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels K1/K2 from ``src/repro_torch/kernels/csrc``
(nvcc, into ``build/repro_torch/``), then:

1. holds each kernel against its plain PyTorch version on the card —
   every paper stencil (plus forced-dense blur2d/star33_3d) x 4
   boundaries x sweeps {1,2,4}, odd shapes, f64 bitwise and f32 within
   1e-5, both kernels per case, plus tiny grids, a periodic grid above
   the whole-grid budget and one batched grid per rank;
2. runs the engine — ``CasperEngine(spec, backend="cuda",
   sweeps=4).run(grid, iters=10)`` — at each paper stencil's Table 3 DRAM
   shape (zero and periodic boundary) and at jacobi2d 8192^2 and heat3d
   512x512x256, all f64, each bitwise equal to ``backend="ref"`` on the
   card; launch counts are reset just before this run and read after;
3. times one fused block per phase-2 case with CUDA events (median),
   beside its bytes bound, the plain version and chained ``F.conv``
   (the yardstick, never used by the port).

Prints the card's name and power limit and a ``{"kernels": [...]}`` line
before the last line, which is ``{"ok": true, "device": {...}}``.  Full
results go to ``build/chip_smoke.json``.  Exits non-zero, printing
no result, when CUDA is missing or any check fails.
"""
from __future__ import annotations

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
F32_ATOL = 1e-5        # f32 kernel vs plain: same op order, no FMA either way
K1_REPLACES = "src/repro/kernels/engine.py:217"   # _padfree_kernel
K2_REPLACES = "src/repro/kernels/engine.py:151"   # _kernel
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
    return torch.randn(shape, dtype=dtype, device="cuda", generator=gen)


def conv_chain(spec, grid, sweeps):
    """The yardstick: ``sweeps`` chained F.conv{1,2,3}d, each on an
    F.pad of the boundary's mode (cuDNN, TF32 off)."""
    nd = spec.ndim
    k = [2 * h + 1 for h in spec.halo]
    w = torch.zeros([1, 1] + k, dtype=grid.dtype, device=grid.device)
    for off, c in spec.taps:
        w[(0, 0) + tuple(h + o for h, o in zip(spec.halo, off))] = c
    pads = []
    for h in reversed(spec.halo):
        pads += [h, h]
    mode = {"zero": "constant", "constant": "constant",
            "periodic": "circular", "reflect": "reflect"}[spec.boundary_mode]
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    x = grid.reshape((1, 1) + tuple(grid.shape))
    for _ in range(sweeps):
        if mode == "constant":
            xp = F.pad(x, pads, mode="constant", value=spec.boundary_value)
        else:
            xp = F.pad(x, pads, mode=mode)
        x = conv(xp, w)
    return x.reshape(grid.shape)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.time()
    from repro_torch import CasperEngine, DOMAIN_SIZES, PAPER_STENCILS
    from repro_torch.core import plan as tplan
    from repro_torch.core import ref as tref
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine as keng

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
    max_err = {"K1": 0.0, "K2": 0.0}
    failures = []

    def compare(kernel, got, want, dtype, label):
        err = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0.0
        max_err[kernel] = max(max_err[kernel], err)
        ok = (torch.equal(got, want) if dtype == torch.float64
              else err <= F32_ATOL)
        if not (ok and got.shape == want.shape
                and bool(torch.isfinite(got).all())):
            failures.append(f"{label}: {kernel} err {err}")
        return err

    def run_kernel(spec, grid, sweeps, strategy, label, dtype):
        before = dict(keng.LAUNCHES)
        got = keng.stencil_sweep(spec, grid, sweeps=sweeps,
                                 strategy=strategy)
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
        if strategy == "pad-free":
            want = keng.stencil_sweep_plain(spec, grid, tile, sweeps)
        else:
            n_shape = tuple(grid.shape[-spec.ndim:])
            wide = tuple(sweeps * h for h in spec.halo)
            window = tref.pad_boundary(grid, wide, spec.boundary_mode,
                                       spec.boundary_value)
            want = keng.stencil_window_sweep_plain(
                spec, window, n_shape, (0,) * spec.ndim, n_shape, tile,
                sweeps)
        compare(ran[0], got, want, dtype, label)
        return ran[0]

    # ---- phase 1: each kernel vs its plain version ----------------------
    t0 = time.time()
    odd = {1: (10007,), 2: (77, 301), 3: (37, 45, 101)}
    specs = [(n, s) for n, s in PAPER_STENCILS.items()]
    specs += [(f"{n}-dense", PAPER_STENCILS[n].with_structure("dense"))
              for n in ("blur2d", "star33_3d")]
    n_cases = 0
    keng.reset_launches()
    for label, spec0 in specs:
        for boundary in BOUNDARIES:
            spec = spec0.with_boundary(boundary)
            for dtype in (torch.float64, torch.float32):
                g = randn(odd[spec.ndim], dtype, gen)
                for sweeps in (1, 2, 4):
                    for strategy in ("pad-free", "padded-window"):
                        run_kernel(spec, g, sweeps, strategy,
                                   f"{label} {boundary} {dtype} s{sweeps}",
                                   dtype)
                        n_cases += 1
    log(f"phase 1: {n_cases} kernel-vs-plain cases on odd shapes "
        f"{list(odd.values())}, launches {dict(keng.LAUNCHES)}, max |err| "
        f"K1 {max_err['K1']} K2 {max_err['K2']} ({time.time() - t0:.1f}s)")
    tiny = {1: (5,), 2: (3, 7), 3: (2, 3, 5)}
    extra = [(f"tiny {n}", PAPER_STENCILS[n].with_boundary(b), tiny[
        PAPER_STENCILS[n].ndim], 1, 4)
        for n in ("7pt1d", "blur2d", "star33_3d") for b in BOUNDARIES]
    extra.append(("periodic over budget jacobi2d",
                  PAPER_STENCILS["jacobi2d"].with_boundary("periodic"),
                  (2048, 2048), 1, 4))
    extra += [(f"batched {n}", PAPER_STENCILS[n].with_boundary("reflect"),
               odd[PAPER_STENCILS[n].ndim], 3, 4)
              for n in ("jacobi1d", "jacobi2d", "heat3d")]
    for label, spec, shape, batch, sweeps in extra:
        shape = (batch,) + shape if batch > 1 else shape
        g = randn(shape, torch.float64, gen)
        kernel = run_kernel(spec, g, sweeps, None, label, torch.float64)
        log(f"  {label} {spec.boundary} {shape} s{sweeps}: plan chose "
            f"{kernel}, equal to plain: "
            f"{not any(f.startswith(label) for f in failures)}")
    if failures:
        raise SystemExit("phase 1 failed:\n" + "\n".join(failures[:40]))

    # ---- phase 2: the engine, counted ----------------------------------
    cases = []
    for n, spec in PAPER_STENCILS.items():
        shape = DOMAIN_SIZES["DRAM"][spec.ndim]
        cases.append((n, spec, shape, "DRAM"))
        cases.append((n, spec.with_boundary("periodic"), shape, "DRAM"))
    cases.append(("jacobi2d", PAPER_STENCILS["jacobi2d"], (8192, 8192),
                  "HBM"))
    cases.append(("heat3d", PAPER_STENCILS["heat3d"], (512, 512, 256),
                  "HBM"))
    grids = [randn(shape, torch.float64, gen) for _, _, shape, _ in cases]
    engines = [CasperEngine(spec, backend="cuda", sweeps=4)
               for _, spec, _, _ in cases]
    torch.cuda.synchronize()
    t0 = time.time()
    keng.reset_launches()
    outs, per_run = [], []
    for eng, g in zip(engines, grids):
        before = sum(keng.LAUNCHES.values())
        outs.append(eng.run(g, iters=10))
        per_run.append(sum(keng.LAUNCHES.values()) - before)
    torch.cuda.synchronize()
    launches = dict(keng.LAUNCHES)
    log(f"phase 2: engine.run(iters=10, sweeps=4) on {len(cases)} grids in "
        f"{time.time() - t0:.2f}s; launches {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"phase 2: a kernel of the path never ran: "
                         f"{launches}")
    results = []
    for (n, spec, shape, level), g, out, k in zip(cases, grids, outs,
                                                  per_run):
        want = CasperEngine(spec, backend="ref").run(g, iters=10)
        equal = torch.equal(out, want)
        finite = bool(torch.isfinite(out).all())
        if not (equal and finite and tuple(out.shape) == tuple(shape)):
            failures.append(f"phase 2 {n} {spec.boundary} {shape}: equal "
                            f"{equal} finite {finite}")
        results.append({"stencil": n, "boundary": spec.boundary,
                        "shape": list(shape), "level": level,
                        "bitwise_equal_ref": equal,
                        "launches_per_run": k})
        del want
    # the card against the host oracle on a small input
    small = randn((37, 45, 101), torch.float64, gen)
    spec = PAPER_STENCILS["star33_3d"].with_boundary("reflect")
    got = CasperEngine(spec, backend="cuda", sweeps=4).run(small, iters=10)
    host = tref.run_iterations(spec, small.cpu(), 10)
    if not torch.equal(got.cpu(), host):
        failures.append("phase 2: card != host oracle (star33_3d reflect)")
    log(f"phase 2: {sum(r['bitwise_equal_ref'] for r in results)}/"
        f"{len(results)} bitwise equal to backend='ref' on the card; "
        f"card == host oracle on star33_3d reflect (37,45,101): "
        f"{'phase 2: card' not in ' '.join(failures)}")
    if failures:
        raise SystemExit("phase 2 failed:\n" + "\n".join(failures))
    del outs

    # ---- phase 3: times ---------------------------------------------------
    log("phase 3: one fused block (sweeps=4) per case, median of CUDA "
        f"events | card {smi}")
    log(f"  {'stencil':10s} {'boundary':9s} {'shape':16s} {'kern':4s} "
        f"{'ms':>8s} {'GB/s':>7s} {'bound':>7s} {'plain':>8s} {'conv':>8s}")
    for r, (n, spec, shape, level), g, eng in zip(results, cases, grids,
                                                  engines):
        plan = eng.plan_for(shape, g.dtype)
        kernel = "K1" if plan.ghost_strategy == "pad-free" else "K2"
        reps = 20 if level == "HBM" else 50
        ms = time_ms(lambda: tplan.execute(plan, g), reps)
        traffic = keng.hbm_traffic(spec, shape, plan.tile, 4, 8)
        nbytes = 2 * math.prod(shape) * 8
        bound = nbytes / hbm_bw * 1e3
        ops = math.prod(shape) * 4 * spec.structured_flops_per_point()
        lib = time_ms(lambda: conv_chain(spec, g, 4), 5 if level == "HBM"
                      else 10)
        # plain version of the same block, held against the kernel
        if kernel == "K1":
            def plain():
                return keng.stencil_sweep_plain(spec, g, plan.tile, 4)
        else:
            wide = plan.deep_halo

            def plain():
                window = tref.pad_boundary(g, wide, spec.boundary_mode,
                                           spec.boundary_value)
                return keng.stencil_window_sweep_plain(
                    spec, window, shape, (0,) * spec.ndim, shape, plan.tile,
                    4)
        compare(kernel, tplan.execute(plan, g), plain(), torch.float64,
                f"phase 3 {n} {spec.boundary} {shape}")
        torch.cuda.empty_cache()
        plain_ms = time_ms(plain, 3, warmup=1)
        torch.cuda.empty_cache()
        r.update(kernel=kernel, tile=list(plan.tile), ms=ms,
                 gbps=traffic["fused_bytes"] / ms / 1e6,
                 fused_bytes=traffic["fused_bytes"], bound_ms=bound,
                 ops_ms=ops / peak_f64 * 1e3, plain_ms=plain_ms,
                 library_ms=lib)
        log(f"  {n:10s} {spec.boundary:9s} {str(tuple(shape)):16s} "
            f"{kernel:4s} {ms:8.4f} {r['gbps']:7.1f} {bound:7.4f} "
            f"{plain_ms:8.2f} {lib:8.3f}")
    if failures:
        raise SystemExit("phase 3 failed:\n" + "\n".join(failures))

    # ---- the kernels line: one representative main-path case each ------
    def kernel_entry(kname, replaces, spec, g, window_call):
        nd = spec.ndim
        shape = tuple(g.shape)
        sweeps = 4
        tile = tplan.default_tile(spec, sweeps, 8)
        wide = tuple(sweeps * h for h in spec.halo)
        if window_call:
            src = tref.pad_boundary(g, wide, spec.boundary_mode,
                                    spec.boundary_value)

            def kern():
                return keng.stencil_window_sweep(spec, src, shape, (0,) * nd,
                                                 shape, tile, sweeps)

            def plain():
                return keng.stencil_window_sweep_plain(
                    spec, src, shape, (0,) * nd, shape, tile, sweeps)
        else:
            src = g

            def kern():
                return keng.stencil_sweep(spec, g, tile, sweeps, "pad-free")

            def plain():
                return keng.stencil_sweep_plain(spec, g, tile, sweeps)
        nbytes = (src.numel() + g.numel()) * 8
        ops = g.numel() * sweeps * spec.structured_flops_per_point()
        t_bytes, t_ops = nbytes / hbm_bw * 1e3, ops / peak_f64 * 1e3
        compare(kname, kern(), plain(), torch.float64, f"kernels {kname}")
        entry = {
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max_err[kname],
            "ms": time_ms(kern, 20),
            "plain_ms": time_ms(plain, 3, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lambda: conv_chain(spec, g, sweeps), 5),
            "shape": list(shape), "spec": spec.name,
            "boundary": spec.boundary, "sweeps": sweeps, "dtype": "float64",
        }
        torch.cuda.empty_cache()
        return entry

    big = grids[[i for i, c in enumerate(cases) if c[3] == "HBM"][0]]
    per = grids[[i for i, c in enumerate(cases)
                 if c[0] == "jacobi2d" and c[1].boundary == "periodic"][0]]
    kernels = [
        kernel_entry("K1", K1_REPLACES, PAPER_STENCILS["jacobi2d"], big,
                     False),
        kernel_entry("K2", K2_REPLACES,
                     PAPER_STENCILS["jacobi2d"].with_boundary("periodic"),
                     per, True),
    ]
    if failures:
        raise SystemExit("kernels line failed:\n" + "\n".join(failures))

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "rates_of": rate_key,
                   "hbm_bw": hbm_bw, "peak_f64": peak_f64,
                   "phase1_cases": n_cases, "launches": launches,
                   "cases": results, "kernels": kernels,
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
