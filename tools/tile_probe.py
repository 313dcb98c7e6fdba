"""Time every candidate tile of ``tile="auto"`` on one GPU, beside the model.

    python3 tools/tile_probe.py [--rounds N] [--only SUBSTR,...] [--no-check]
        [--out FILE]

The data the Hopper tile cost model
(``repro_torch.core.perfmodel.cuda_tile_cost``) is held to and its
constants come from, f64, sweeps=4:

* the card's copy bandwidth (1 GiB read + 1 GiB written, best of 10),
  its L2 bandwidth (a 16 MiB copy, 100 times in one CUDA graph while both
  buffers stay in L2, best of 10) and the launch floor of one fused
  block (jacobi1d on 64 points, the wrapper's host path included,
  per-call CUDA events, median);
* every candidate tile the autotuner draws (``kernels.tune.candidate_tiles``,
  fitted to the grid) that fits shared memory, on the engine's main-path
  cases (``chip_smoke.py`` phases 2a, 2b and 2d: each paper stencil at
  its Table 3 DRAM shape, zero and periodic and periodic forced to the
  padded window, jacobi2d 8192^2, heat3d 512x512x256, the pipelines, the
  serving batches), timed by ``kernels.tune.measure_tiles`` (one block
  per call between CUDA events, the tiles in turn, ``--rounds`` rounds,
  median), beside the model's seconds under the shipped constants, the
  CTAs, CTAs per SM, plane steps, bytes and operations it charges;
* unless ``--no-check``: every candidate tile of every paper stencil and
  pipeline x 4 boundaries on an odd and an aligned shape, both entries,
  held against the plain version (f64 bitwise; f32 within 1e-5 on the
  aligned shape), so that a tile the kernels never ran before is checked
  before it is timed;
* the timing method on three cases: the same tiles timed interleaved
  (``measure_tiles``), as consecutive single calls and back to back (20
  calls between one pair of events).

``--only`` keeps the timed cases whose label holds one of the given
substrings.  Prints the card's name and power limit; the last line is one
JSON object with every number (``--out`` writes it too).

    python3 tools/tile_probe.py --fit FILE [--free KEY,...]

fits the model to a probe's JSON on the host (no card; needs scipy): the
L2 rate and the launch floor (half the floor measured, a block of a grid
below one window being a pad and a K2 launch) are taken as measured, the
``--free`` constants (default ``gpu_cta_step_s,gpu_plane_step_s``) by
least squares on the log of every 2a/2b block time, the rest at their
shipped values; prints the fitted constants as a ``CASPER_CALIBRATION``
object and, per case, the model's top tile and its measured time over
the best.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def cases():
    """The main-path cases of ``chip_smoke.py`` phase 2a, 2b and 2d:
    (label, spec, grid shape with any batch first, forced strategy)."""
    from repro_torch import (DOMAIN_SIZES, PAPER_PIPELINES, PAPER_STENCILS,
                             StencilPipeline)
    out = []
    for n, spec in PAPER_STENCILS.items():
        shape = DOMAIN_SIZES["DRAM"][spec.ndim]
        out.append((f"2a {n} zero", spec, shape, None))
        per = spec.with_boundary("periodic")
        out.append((f"2a {n} periodic", per, shape, None))
        out.append((f"2a {n} periodic forced K2", per, shape,
                    "padded-window"))
    out.append(("2a jacobi2d zero 8192^2", PAPER_STENCILS["jacobi2d"],
                (8192, 8192), None))
    out.append(("2a heat3d zero 512x512x256", PAPER_STENCILS["heat3d"],
                (512, 512, 256), None))
    rd = PAPER_PIPELINES["reaction_diffusion2d"]
    ad = PAPER_PIPELINES["advect_diffuse2d"]
    mixed = StencilPipeline("mixed_rd", (
        rd.stages[0].with_boundary("zero"),
        rd.stages[1].with_boundary("constant(0.75)"),
        rd.stages[0].with_boundary("reflect")))
    out += [("2b reaction_diffusion2d 2048^2", rd, (2048, 2048), None),
            ("2b reaction_diffusion2d 8192^2", rd, (8192, 8192), None),
            ("2b advect_diffuse2d 2048^2", ad, (2048, 2048), None),
            ("2b advect_diffuse2d 2048^2 forced K4", ad, (2048, 2048),
             "padded-window"),
            ("2b advect_diffuse2d 1024^2", ad, (1024, 1024), None),
            ("2b mixed_rd 2048^2", mixed, (2048, 2048), None)]
    jac2 = PAPER_STENCILS["jacobi2d"]
    out += [("2d jacobi2d 8x8 x70000", jac2, (70000, 8, 8), None),
            ("2d jacobi2d (32,64) x48", jac2, (48, 32, 64), None),
            ("2d jacobi2d (32,64) x4096", jac2, (4096, 32, 64), None),
            ("2d jacobi1d (512,) x4096", PAPER_STENCILS["jacobi1d"],
             (4096, 512), None),
            ("2d reaction_diffusion2d (32,64) x4096", rd, (4096, 32, 64),
             None),
            ("2d advect2d periodic (32,64) x4096", ad.stages[0],
             (4096, 32, 64), None),
            ("2d heat3d (8,12,16) x4096", PAPER_STENCILS["heat3d"],
             (4096, 8, 12, 16), None)]
    return out


def model_terms(spec, shape, tile, sweeps, itemsize) -> dict:
    """What the cost model charges ``tile`` (shipped constants)."""
    from repro_torch.core import perfmodel as pm
    from repro_torch.core import plan as tplan
    smem = tplan.smem_bytes(tile, spec, sweeps, itemsize)
    streamed = tplan.streams(spec)
    resident = min(pm.STREAM_CTAS_PER_SM if streamed else tplan.CTAS_PER_SM,
                   pm.H100_SMEM_PER_SM
                   // (smem + pm.H100_SMEM_RESERVED_PER_BLOCK))
    out = math.prod(tile)
    window = math.prod(t + 2 * sweeps * h for t, h in zip(tile, spec.halo))
    points, flops = pm._points_and_flops(spec, tile, sweeps)
    return {"ctas": tplan.launch_blocks(shape, tile, 1), "smem": smem,
            "resident": resident, "hbm_bytes": 2 * out * itemsize,
            "l2_bytes": (window - out) * itemsize, "points": points,
            "flops": flops,
            "steps": (tile[0] + 2 * sweeps * spec.halo[0] + sweeps - 1
                      if streamed else 0),
            "strategy": tplan.ghost_strategy_for(spec, shape, itemsize,
                                                 sweeps, tile),
            "model_s": pm.cuda_tile_cost(spec, shape, tile, sweeps,
                                         itemsize)}


def fit(path: str, free: list[str]) -> int:
    """Least-squares fit of the cost model's ``free`` constants to the
    2a/2b block times of a probe's JSON (see the module docstring)."""
    import numpy as np
    from scipy.optimize import least_squares
    from repro_torch import StencilPipeline
    from repro_torch.core import perfmodel as pm
    with open(path) as fh:
        probe = json.load(fh)
    known = {c[0]: c for c in cases()}
    rows = []
    for r in probe["cases"]:
        label = r["label"]
        if not label.startswith(("2a", "2b")):
            continue
        _, spec, shape, forced = known[label]
        if isinstance(spec, StencilPipeline) and not spec.fusable:
            continue
        for t in r["tiles"]:
            rows.append((label, tuple(t["tile"]), t["ms"] * 1e-3, spec,
                         tuple(shape), forced))
    fixed = {"gpu_l2_bw": probe["l2_bw"],
             "gpu_launch_s": probe["launch_s"] / 2}
    start = {"gpu_cta_step_s": 1e-8, "gpu_plane_step_s": 2e-6,
             "gpu_peak_flops_f64": 5e12, "gpu_launch_s": 5e-5,
             "gpu_bw": 3e12, "gpu_l2_bw": 5e12}

    def model(cal):
        os.environ[pm.CALIBRATION_ENV] = json.dumps(cal)
        launch = cal.get("gpu_launch_s", pm.H100_LAUNCH_S)
        # a forced row pays the pad the plan adds to its pad-free tiles
        return np.array([pm.cuda_tile_cost(spec, shape, tile, 4, 8)
                         + (launch if forced else 0.0)
                         for _, tile, _, spec, shape, forced in rows])

    def calib(x):
        return {**fixed, **dict(zip(free, map(float, np.exp(x))))}

    seconds = np.array([r[2] for r in rows])
    res = least_squares(lambda x: np.log(model(calib(x)) / seconds),
                        np.log([start[k] for k in free]))
    cal = calib(res.x)
    cost = model(cal)
    del os.environ[pm.CALIBRATION_ENV]
    print(f"fit of {free} to {len(rows)} block times of {path} "
          f"({probe['card']}): rms log error "
          f"{math.sqrt(float(np.mean(res.fun ** 2))):.3f}")
    by = {}
    for (label, tile, sec, *_), c in zip(rows, cost):
        by.setdefault(label, []).append((c, sec, tile))
    for label, entries in by.items():
        top = min(entries)
        best = min(e[1] for e in entries)
        print(f"  {label:40s} model top {top[2]} {top[1] * 1e3:.4f} ms, "
              f"best {best * 1e3:.4f} ms (x{top[1] / best:.3f})")
    print(json.dumps(cal))
    return 0


def main() -> int:
    if "--fit" in sys.argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--fit", required=True)
        ap.add_argument("--free", default="gpu_cta_step_s,gpu_plane_step_s")
        args = ap.parse_args()
        return fit(args.fit, args.free.split(","))
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--only", default=None)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tile_probe: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS, StencilPipeline
    from repro_torch.core import plan as tplan
    from repro_torch.core import ref as tref
    from repro_torch.kernels import _build, tune
    from repro_torch.kernels import engine as keng

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__}", flush=True)
    t0 = time.time()
    _build.load(keng.SOURCE)
    print(f"build: {time.time() - t0:.1f}s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20211228)
    result = {"card": smi}

    def event_ms(fn, reps):
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return times

    # ---- the card's rates --------------------------------------------------
    x = torch.empty(2 ** 27, dtype=torch.float64, device="cuda")
    y = torch.empty_like(x)
    x.fill_(1.0)
    y.copy_(x)
    hbm = 2 * x.numel() * 8 / (min(event_ms(lambda: y.copy_(x), 10)) / 1e3)
    del x, y
    # 16 MiB copied into 16 MiB, 100 times in one CUDA graph (no host
    # launch between copies): both buffers stay in the 50 MB L2
    xs = torch.ones(2 ** 22, dtype=torch.float32, device="cuda")
    ys = torch.empty_like(xs)
    inner = 100
    ys.copy_(xs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            ys.copy_(xs)
    graph.replay()
    l2 = 2 * xs.numel() * 4 * inner / (min(event_ms(graph.replay, 10)) / 1e3)
    del graph, xs, ys
    small = torch.randn((64,), dtype=torch.float64, device="cuda",
                        generator=gen)
    jac1 = PAPER_STENCILS["jacobi1d"]
    for _ in range(3):
        keng.stencil_apply(jac1, small, sweeps=4)
    launch = statistics.median(event_ms(
        lambda: keng.stencil_apply(jac1, small, sweeps=4), 51)) / 1e3
    result.update(hbm_bw=hbm, l2_bw=l2, launch_s=launch)
    print(f"rates: HBM copy {hbm:.4g} B/s, L2 copy {l2:.4g} B/s, launch "
          f"floor {launch * 1e6:.2f} us | card {smi}", flush=True)

    # ---- correctness of every candidate tile ------------------------------
    if not args.no_check:
        t0 = time.time()
        odd = {1: (10007,), 2: (77, 301), 3: (37, 45, 101)}
        aligned = {1: (20480,), 2: (160, 512), 3: (72, 80, 96)}
        specs = list(PAPER_STENCILS.values()) + list(PAPER_PIPELINES.values())
        bad, n_ok = [], 0
        for spec0 in specs:
            for boundary in ("zero", "constant(0.75)", "periodic", "reflect"):
                spec = spec0.with_boundary(boundary)
                pipe = isinstance(spec, StencilPipeline)
                for shapes, dtypes in ((odd, (torch.float64,)),
                                       (aligned, (torch.float64,
                                                  torch.float32))):
                    shape = shapes[spec.ndim]
                    for dtype in dtypes:
                        g = torch.randn(shape, dtype=torch.float64,
                                        device="cuda", generator=gen).to(dtype)
                        isz = g.element_size()
                        for tile in tune.candidate_tiles(
                                spec.ndim, shape, spec=spec, sweeps=4,
                                itemsize=isz):
                            if (tplan.smem_bytes(tile, spec, 4, isz)
                                    > tplan._pm.H100_SMEM_PER_BLOCK):
                                continue
                            for strategy in ("pad-free", "padded-window"):
                                fn = (keng.pipeline_sweep if pipe
                                      else keng.stencil_sweep)
                                got = fn(spec, g, tile, 4, strategy)
                                if strategy == "pad-free":
                                    want = keng.stencil_sweep_plain(
                                        spec, g, tile, 4)
                                else:
                                    wide = tuple(4 * h for h in spec.halo)
                                    win = tref.pad_boundary(
                                        g, wide, spec.boundary_mode,
                                        spec.boundary_value)
                                    want = keng.stencil_window_sweep_plain(
                                        spec, win, shape, (0,) * spec.ndim,
                                        shape, tile, 4)
                                ok = (torch.equal(got, want)
                                      if dtype == torch.float64 else
                                      (got - want).abs().max().item() <= 1e-5)
                                if ok:
                                    n_ok += 1
                                else:
                                    bad.append(f"{spec.name} {boundary} "
                                               f"{dtype} {shape} {tile} "
                                               f"{strategy}")
        torch.cuda.synchronize()
        result["check"] = {"equal": n_ok, "bad": bad}
        print(f"check: {n_ok} tile cases equal to the plain version, "
              f"{len(bad)} not: {bad[:10]} ({time.time() - t0:.1f}s)",
              flush=True)

    # ---- the timing method: interleaved single calls, consecutive single
    # calls and back-to-back calls, on the same tiles -----------------------
    methods = []
    for label, spec, shape, tiles in (
            ("jacobi1d zero 4M", jac1, (4194304,), ((4096,), (2048,))),
            ("jacobi2d zero 2048^2", PAPER_STENCILS["jacobi2d"], (2048, 2048),
             ((64, 64), (32, 128), (32, 64))),
            ("jacobi2d zero 8192^2", PAPER_STENCILS["jacobi2d"], (8192, 8192),
             ((64, 64), (32, 128), (32, 64)))):
        g = torch.randn(shape, dtype=torch.float64, device="cuda",
                        generator=gen)
        inter = dict(tune.measure_tiles(spec, g, tiles, 4, 25))
        for tile in tiles:
            def block(tile=tile):
                return keng.stencil_apply(spec, g, tile=tile, sweeps=4)
            for _ in range(2):
                block()
            single = statistics.median(event_ms(block, 25))

            def twenty():
                for _ in range(20):
                    block()
            b2b = statistics.median(event_ms(twenty, 5)) / 20
            methods.append({"case": label, "tile": list(tile),
                            "interleaved_ms": inter[tile] * 1e3,
                            "consecutive_ms": single, "back_to_back_ms": b2b})
            print(f"method {label} {tile}: interleaved "
                  f"{inter[tile] * 1e3:.4f} ms, consecutive {single:.4f}, "
                  f"back to back {b2b:.4f} | card {smi}", flush=True)
        del g
    result["methods"] = methods

    # ---- every candidate on the main-path cases ---------------------------
    only = args.only.split(",") if args.only else None
    rows = []
    for label, spec, shape, forced in cases():
        if only and not any(o in label for o in only):
            continue
        g = torch.randn(shape, dtype=torch.float64, device="cuda",
                        generator=gen)
        gshape = tuple(shape[len(shape) - spec.ndim:])
        cands = [t for t in tune.candidate_tiles(spec.ndim, gshape, spec=spec,
                                                 sweeps=4, itemsize=8)
                 if tplan.smem_bytes(t, spec, 4, 8)
                 <= tplan._pm.H100_SMEM_PER_BLOCK]
        staged = isinstance(spec, StencilPipeline) and not spec.fusable
        timed = dict(tune.measure_tiles(spec, g, cands, 4, args.rounds,
                                        forced))
        default = tplan.normalize_tile(spec, None, 4, 8, gshape)
        auto = None
        if not staged:
            tuner = (tune.autotune_pipeline
                     if isinstance(spec, StencilPipeline) else tune.autotune)
            auto = tuner(spec, gshape, 4, 8).tile
        best = min(timed.values())
        print(f"{label} {shape}: default {default} auto {auto} | card {smi}",
              flush=True)
        row = {"label": label, "shape": list(shape), "forced": forced,
               "default": list(default), "auto": auto and list(auto),
               "tiles": []}
        for tile in cands:
            terms = ({} if staged else
                     model_terms(spec, gshape, tile, 4, 8))
            ms = timed[tile] * 1e3
            row["tiles"].append({"tile": list(tile), "ms": ms, **terms})
            print(f"  {str(tile):14s} {ms:9.4f} ms  x{ms / best / 1e3:5.2f}"
                  + ("" if staged else
                     f" | model {terms['model_s'] * 1e3:9.4f} ms, "
                     f"{terms['ctas']} CTAs, {terms['resident']}/SM, "
                     f"{terms['strategy']}"), flush=True)
        rows.append(row)
        del g
        torch.cuda.empty_cache()
    result["cases"] = rows
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(smi)
    print(text)
    return 1 if result.get("check", {}).get("bad") else 0


if __name__ == "__main__":
    sys.exit(main())
