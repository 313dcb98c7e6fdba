"""Time the stencil kernel K1-K4 (``csrc/stencil.cu``) against variants of
itself on one GPU, each with one design step taken out or one probe put in.

    python3 tools/stencil_variants.py [--out FILE] [--reps N] [--rounds N]
        [--variants A,B] [--cases SUBSTR,...]

The checkout's ``stencil.cu`` is copied into ``build/variants/`` and each
variant is made by replacing exact fragments of the copy (every
occurrence: the window and the streamed kernel share some), a ``#define``
among them (the checkout's source is not changed); every copy is built by
``nvcc`` at once and swapped in as the library behind ``kernels.engine``:

* ``kept``: the source as it is;
* ``plain_loads``: interior windows loaded element by element, not by
  16-byte ``cp.async`` (step 4 out);
* ``no_strips``: radius-1 star stages without the row strips that hold
  the center column in registers (step 3 out);
* ``no_reg_taps``: also no tap sets held in registers (every stage reads
  its taps from the argument block per point) and one point per thread
  per step instead of two;
* ``strip8``: strips of 8 rows instead of 4;
* ``one_block``, ``three_blocks``: registers budgeted for one or three
  CTAs per SM instead of two;
* ``threads384``, ``threads512``: CTAs of 384 or 512 threads instead of
  256 (two per SM, so fewer registers each);
* ``stream256``, ``stream512``: CTAs of the streamed rank-3 kernel of
  256 or 512 threads instead of 384;
* ``core27_tabled``: star33_3d's stage on the streamed kernel's general
  evaluator (``TabledOp``, taps read per point) instead of ``Core27Op``;
* ``probe_load_only``: the window loaded and the tile written straight
  from it, no application (wrong results; the load and store floor);
* ``probe_compute_only``: every application, no window load (wrong
  results; the compute floor);
* ``probe_stream_load_only``, ``probe_stream_compute_only``: the same two
  probes of the streamed rank-3 kernel (every plane loaded and no
  application formed; every application formed and no plane loaded).

Cases, f64 at sweeps=4: K3 on reaction_diffusion2d (reflect) at 8192^2
and on the mixed zero/constant/reflect chain at 2048^2, K1 on jacobi2d
(zero) at 8192^2, heat3d at 512x512x256 and star33_3d at 256x256x64
(streamed), the staged reaction_diffusion2d
chain (8 K1 launches) at 8192^2, K2 on jacobi2d (periodic) at 2048^2 and
K4 on advect_diffuse2d at 2048^2 (pre-padded windows); and K3/K1 at
8192^2 and heat3d with explicit tiles other than the default.  Each
variant that
is not a probe must equal ``kept`` bitwise on every case.  Times are CUDA
event medians, the variants taken in turn, ``--rounds`` times over.  The
last line is one JSON object with every number; ``--out`` writes it too.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOAD_START = "  if (a.padded) {\n    for_box<R>(win[0], win[1], win[2]"
_APPLY_START = "  // ---- sweeps x n_stages fused applications"
_COPY_OUT = """  {
    S* __restrict__ dst = out + (size_t)blockIdx.y * ((size_t)a.out[0] * a.out[1] * a.out[2]);
    for_box<R>(a.tile[0], a.tile[1], a.tile[2], [&](int q0, int q1, int q2) {
      const int o0 = base[0] + q0, o1 = base[1] + q1, o2 = base[2] + q2;
      if (o0 < a.out[0] && o1 < a.out[1] && o2 < a.out[2])
        dst[((size_t)o0 * a.out[1] + o1) * a.out[2] + o2] = Acc<S>::store(
            w0[(full[0] + q0) * pl0 + (full[1] + q1) * row + full[2] + q2]);
    });
    return;
  }
"""
_PAIRS = """    const bool has_b = i + NTH < n;
    const auto va = get(a0, a1, a2);
    const auto vb = has_b ? get(b0, b1, b2) : va;
    put(a0, a1, a2, va);
    if (has_b) put(b0, b1, b2, vb);"""
_SINGLE = """    put(a0, a1, a2, get(a0, a1, a2));
    if (i + NTH < n) put(b0, b1, b2, get(b0, b1, b2));"""
_NO_ASYNC = [("if (a.async_load) {", "if (false) {")]


def _define(name: str, old: int, new: int):
    return [(f"#define {name} {old} ", f"#define {name} {new} ")]



_NO_STRIPS = _NO_ASYNC + [("if (R == 2 && st.star == 2)", "if (false)")]
VARIANTS = {
    "kept": [],
    "plain_loads": _NO_ASYNC,
    "no_strips": _NO_STRIPS,
    "no_reg_taps": _NO_STRIPS + [
        (f"run(FixedTaps<T, {n}>(a, st, bi));", "run(AnyStage<T>{a, st, bi});")
        for n in (3, 5, 7)] + [(_PAIRS, _SINGLE)],
    "strip8": _define("CASPER_STRIP", 4, 8),
    "one_block": _define("CASPER_MIN_BLOCKS", 2, 1),
    "three_blocks": _define("CASPER_MIN_BLOCKS", 2, 3),
    "threads384": _define("CASPER_THREADS", 256, 384),
    "threads512": _define("CASPER_THREADS", 256, 512),
    "stream256": _define("CASPER_STREAM_THREADS", 384, 256),
    "stream512": _define("CASPER_STREAM_THREADS", 384, 512),
    "core27_tabled": [("if (st.star == CASPER_CORE27) {", "if (false) {")],
    "probe_load_only": [(_APPLY_START, _COPY_OUT + _APPLY_START)],
    "probe_compute_only": [(_LOAD_START, "  if (true) {\n  } else " + _LOAD_START[2:])],
    "probe_stream_load_only": [("      if (!active(l, j)) continue;",
                                "      if (true) continue;")],
    "probe_stream_compute_only": [
        ("    if (p < planes0) load_plane(z_first + p);", ""),
        ("    if (j + CASPER_STREAM_AHEAD < planes0) load_plane(", "    if (false) load_plane(")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", help="comma-separated variants to build "
                    "and time beside 'kept' (default: all)")
    ap.add_argument("--cases", help="comma-separated substrings: time only "
                    "the cases whose label holds one (default: all)")
    args = ap.parse_args()
    variants = dict(VARIANTS)
    if args.variants:
        wanted = args.variants.split(",")
        unknown = set(wanted) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"unknown variants: {sorted(unknown)}")
        variants = {n: VARIANTS[n] for n in ["kept"] + wanted}
    import torch
    if not torch.cuda.is_available():
        print("stencil_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS, StencilPipeline
    from repro_torch.core import ref as tref
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine as keng

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                           "stencil.cu")) as fh:
        text = fh.read()
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.nvcc_path()
    jobs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if not src.count(old):
                raise SystemExit(f"{name}: fragment not found: {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", lib, path]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)

    gen = torch.Generator(device="cuda").manual_seed(20211228)

    def randn(*shape):
        return torch.randn(shape, dtype=torch.float64, device="cuda", generator=gen)

    big, mid, cube = randn(8192, 8192), randn(2048, 2048), randn(512, 512, 256)
    small_cube = randn(256, 256, 64)
    rd = PAPER_PIPELINES["reaction_diffusion2d"]
    ad = PAPER_PIPELINES["advect_diffuse2d"]
    mixed = StencilPipeline("mixed_rd", (
        rd.stages[0].with_boundary("zero"),
        rd.stages[1].with_boundary("constant(0.75)"),
        rd.stages[0].with_boundary("reflect")))
    jac, jac_p = PAPER_STENCILS["jacobi2d"], PAPER_STENCILS["jacobi2d"].with_boundary("periodic")
    win_j = tref.pad_boundary(mid, (4, 4), "periodic")
    win_a = tref.pad_boundary(mid, (8, 8), "periodic")
    cases = {
        "K3 reaction_diffusion2d reflect 8192^2":
            lambda: keng.pipeline_sweep(rd, big, None, 4, "pad-free"),
        "K3 mixed_rd 2048^2": lambda: keng.pipeline_sweep(mixed, mid, None, 4, "pad-free"),
        "K1 jacobi2d zero 8192^2": lambda: keng.stencil_sweep(jac, big, None, 4, "pad-free"),
        "K1 heat3d zero 512x512x256":
            lambda: keng.stencil_sweep(PAPER_STENCILS["heat3d"], cube, None, 4, "pad-free"),
        "K1 star33_3d zero 256x256x64":
            lambda: keng.stencil_sweep(PAPER_STENCILS["star33_3d"], small_cube, None, 4,
                                       "pad-free"),
        "staged reaction_diffusion2d 8192^2 (8 K1)":
            lambda: keng.pipeline_sweep(rd, big, None, 4, "staged"),
        "K2 jacobi2d periodic 2048^2 (window)":
            lambda: keng.stencil_window_sweep(jac_p, win_j, (2048, 2048), (0, 0),
                                              (2048, 2048), None, 4),
        "K4 advect_diffuse2d 2048^2 (window)":
            lambda: keng.pipeline_window_sweep(ad, win_a, (2048, 2048), (0, 0),
                                               (2048, 2048), None, 4),
    }
    for tile in ((32, 64), (64, 64), (48, 96), (16, 128)):
        cases[f"K3 reaction_diffusion2d 8192^2 tile {tile}"] = \
            lambda t=tile: keng.pipeline_sweep(rd, big, t, 4, "pad-free")
        cases[f"K3 mixed_rd 2048^2 tile {tile}"] = \
            lambda t=tile: keng.pipeline_sweep(mixed, mid, t, 4, "pad-free")
        cases[f"K1 jacobi2d 8192^2 tile {tile}"] = \
            lambda t=tile: keng.stencil_sweep(jac, big, t, 4, "pad-free")
    for tile in ((4, 16, 32), (8, 8, 32)):
        cases[f"K1 heat3d 512x512x256 tile {tile}"] = \
            lambda t=tile: keng.stencil_sweep(PAPER_STENCILS["heat3d"], cube, t, 4,
                                              "pad-free")

    if args.cases:
        cases = {label: fn for label, fn in cases.items()
                 if any(sub in label for sub in args.cases.split(","))}

    def time_ms(fn) -> float:
        for _ in range(2):
            fn()
        times = []
        for _ in range(args.reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    result = {"card": smi, "torch": torch.__version__, "reps": args.reps,
              "variants": {n: {"times": {c: [] for c in cases}, "equal_to_kept": True}
                           for n in variants}}
    kept = {}
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            _build._LIBS[keng.SOURCE] = lib
            row = result["variants"][name]
            for label, fn in cases.items():
                if rnd == 0:
                    got = fn()
                    torch.cuda.synchronize()
                    if name == "kept":
                        kept[label] = got
                    elif not name.startswith("probe") and not torch.equal(got, kept[label]):
                        row["equal_to_kept"] = False
                    del got
                ms = time_ms(fn)
                row["times"][label].append(ms)
                print(f"round {rnd} {name:18s} {label:52s} {ms:8.4f} ms", flush=True)
    bad = [n for n, r in result["variants"].items() if not r["equal_to_kept"]]
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    if bad:
        print(f"stencil_variants: not equal to kept: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
