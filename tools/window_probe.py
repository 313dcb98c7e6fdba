"""Time the padded-window stencil entries K2/K4 on the grids they serve, on one GPU.

    python3 tools/window_probe.py [--root DIR ...] [--rounds N] [--reps N]
        [--only SUBSTR,...] [--no-variants] [--out FILE]

Each ``--root`` is the root of a checkout whose ``src/repro_torch`` is
timed (default: this one); several roots are timed in turns, ``--rounds``
times over (``--root A --root B --rounds 2`` gives A, B, A, B), each in
its own subprocess, so that two versions of the kernel are compared
within one call on one card.  Rows (sweeps=4, f64 and f32, a batch of
grids as one launch):

* jacobi2d zero 8x8 x 70,000 (K2), (32, 64) x 48 (a serving bucket) and
  x 4096 (K2); jacobi1d zero (512,) x 4096 (K2); reaction_diffusion2d
  reflect (32, 64) x 4096 (K4); advect2d periodic (32, 64) x 4096 (K1);
  heat3d zero (8, 12, 16) x 4096 (the streamed rank-3 kernel);
* the pre-padded rows: K2 jacobi2d periodic 2048^2 and K4
  advect_diffuse2d 2048^2, one grid each;
* K1 jacobi2d zero 8192^2 and K3 reaction_diffusion2d reflect 8192^2
  (``block`` is the pad-free entry), whose code the window entry shares.

Per row, CUDA-event medians of: ``block``, one fused block as the
wrappers run it with the plan's strategy and tile (``pad_boundary`` and
the kernel for K2/K4); ``kernel``, the padded-window kernel alone on the
pre-padded window; ``pad``, the host ``pad_boundary`` alone; ``k1``, the
pad-free entry (K1/K3) forced on the same grids; ``conv``, the batched
yardstick ``F.pad`` + ``F.conv`` per stage over N = batch, C = 1 (cuDNN,
TF32 off; never called by the port); and, unless ``--no-variants``, the
kernel alone on two probe builds of the root's ``stencil.cu``:
``load_only`` (the window loaded and the tile written straight from it,
no application) and ``compute_only`` (every application, no window
load).  The kernel alone is also timed ten calls back to back
(``kernel_back_to_back``, per call) and by ``torch.profiler``
(``kernel_device``: the kernels' device time, without the host's launch
path, which sets the single call's time on the smallest batches).  The probes give wrong results by design; every other pair is
checked bitwise (f64) or within 1e-5 (f32) against the plain version.
Each row also carries its bound: the larger of one read and one write of
the grids at 3.35 TB/s and the operations the contract fixes
(``structured_flops_per_point``, no FMA) at half the data sheet's f64
(34e12) or f32 (67e12) rate.  Prints the card's name and power limit;
the last line is one JSON object with every number (``--out`` writes it
too).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BW, OPS = 3.35e12, {"float64": 34e12 / 2, "float32": 67e12 / 2}

# (label, stencil or pipeline, boundary, shape, batch): the plan decides
# the kernel
ROWS = (
    ("jacobi2d zero 8x8 x70000", "jacobi2d", "zero", (8, 8), 70000),
    ("jacobi2d zero (32,64) x48", "jacobi2d", "zero", (32, 64), 48),
    ("jacobi2d zero (32,64) x4096", "jacobi2d", "zero", (32, 64), 4096),
    ("jacobi1d zero (512,) x4096", "jacobi1d", "zero", (512,), 4096),
    ("reaction_diffusion2d reflect (32,64) x4096", "reaction_diffusion2d",
     "reflect", (32, 64), 4096),
    ("advect2d periodic (32,64) x4096", "advect2d", "periodic", (32, 64),
     4096),
    ("heat3d zero (8,12,16) x4096", "heat3d", "zero", (8, 12, 16), 4096),
    ("K2 jacobi2d periodic 2048^2 pre-padded", "jacobi2d", "periodic",
     (2048, 2048), 1),
    ("K4 advect_diffuse2d periodic 2048^2 pre-padded", "advect_diffuse2d",
     "periodic", (2048, 2048), 1),
    # the pad-free entry on grids larger than a tile, whose code shares
    # the window kernel's: "block" is K1/K3
    ("K1 jacobi2d zero 8192^2", "jacobi2d", "zero", (8192, 8192), 1),
    ("K3 reaction_diffusion2d reflect 8192^2", "reaction_diffusion2d",
     "reflect", (8192, 8192), 1),
)

# Probe builds: exact fragments of a checkout's stencil.cu and what
# replaces them (a set is taken when all its fragments are found).
_APPLY = "  // ---- sweeps x n_stages fused applications"
_PARENT_LOAD = "  if (a.padded) {\n    for_box<R>(win[0], win[1], win[2]"
_PARENT_COPY_OUT = """  {
    S* __restrict__ dst = out + (size_t)item * ((size_t)a.out[0] * a.out[1] * a.out[2]);
    for_box<R>(a.tile[0], a.tile[1], a.tile[2], [&](int q0, int q1, int q2) {
      const int o0 = base[0] + q0, o1 = base[1] + q1, o2 = base[2] + q2;
      if (o0 < a.out[0] && o1 < a.out[1] && o2 < a.out[2])
        dst[((size_t)o0 * a.out[1] + o1) * a.out[2] + o2] = Acc<S>::store(
            w0[(full[0] + q0) * pl0 + (full[1] + q1) * row + full[2] + q2]);
    });
    return;
  }
"""
# the redesigned entry (fitted tiles, packed CTAs: dim 0 of the tile is
# tl[0], of the output ox0)
_COPY = "  if (copy) {\n    const int c0"
_COPY_OUT = """  {
    S* __restrict__ dst = out + (size_t)item * ((size_t)a.out[0] * a.out[1] * a.out[2]);
    for_box<R>(tl[0], tl[1], tl[2], [&](int q0, int q1, int q2) {
      const int o0 = base[0] + q0, o1 = base[1] + q1, o2 = base[2] + q2;
      if (o0 < ox0 && o1 < a.out[1] && o2 < a.out[2])
        dst[((size_t)o0 * a.out[1] + o1) * a.out[2] + o2] = Acc<S>::store(
            w0[(full[0] + q0) * pl0 + (full[1] + q1) * row + full[2] + q2]);
    });
    return;
  }
"""
PROBES = {
    "load_only": [[(_COPY, _COPY), (_APPLY, _COPY_OUT + _APPLY)],
                  [(_APPLY, _PARENT_COPY_OUT + _APPLY)]],
    "compute_only": [[(_COPY, "  if (true) {\n  } else " + _COPY[2:])],
                     [(_PARENT_LOAD,
                       "  if (true) {\n  } else " + _PARENT_LOAD[2:])]],
}


def _probe_sources(text: str) -> dict:
    out = {}
    for name, sets in PROBES.items():
        for subs in sets:
            if all(text.count(old) for old, _ in subs):
                src = text
                for old, new in subs:
                    src = src.replace(old, new)
                out[name] = src
                break
        else:
            raise SystemExit(f"probe {name}: no fragment set matches")
    return out


def _child(root: str, reps: int, only: str | None, variants: bool) -> dict:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS, StencilPipeline
    from repro_torch.core import plan as tplan
    from repro_torch.core import ref as tref
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine as keng

    torch.backends.cudnn.allow_tf32 = False
    kept = _build.load(keng.SOURCE)
    libs = {"kept": kept}
    if variants:
        csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
        with open(os.path.join(csrc, keng.SOURCE)) as fh:
            text = fh.read()
        out_dir = os.path.join(root, "build", "window_probe")
        os.makedirs(out_dir, exist_ok=True)
        jobs = {}
        for name, src in _probe_sources(text).items():
            path = os.path.join(out_dir, f"{name}.cu")
            with open(path, "w") as fh:
                fh.write(src)
            lib = os.path.join(out_dir, f"lib{name}.so")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
                   lib, path]
            jobs[name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for name, (lib, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
            libs[name] = ctypes.CDLL(lib)
    gen = torch.Generator(device="cuda").manual_seed(20211228)

    def time_ms(fn) -> float:
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def spec_of(name, boundary):
        if name in PAPER_PIPELINES:
            pipe = PAPER_PIPELINES[name]
            assert all(s.boundary == boundary for s in pipe.stages)
            return pipe
        if name == "advect2d":
            return PAPER_PIPELINES["advect_diffuse2d"].stages[0] \
                .with_boundary(boundary)
        return PAPER_STENCILS[name].with_boundary(boundary)

    def conv_chain(spec, g):
        """F.pad + F.conv per stage, four sweeps, over N = batch, C = 1."""
        nd = spec.ndim
        conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
        steps = []
        stages = spec.stages if isinstance(spec, StencilPipeline) else (spec,)
        for st in stages:
            w = torch.zeros([1, 1] + [2 * h + 1 for h in st.halo],
                            dtype=g.dtype, device="cuda")
            for off, c in st.taps:
                w[(0, 0) + tuple(h + o for h, o in zip(st.halo, off))] = c
            pads = []
            for h in reversed(st.halo):
                pads += [h, h]
            mode = {"zero": "constant", "constant": "constant",
                    "periodic": "circular", "reflect": "reflect"}[
                        st.boundary_mode]
            steps.append((w, pads, mode, st.boundary_value))
        x0 = g.reshape((-1, 1) + tuple(g.shape[-nd:]))

        def run():
            x = x0
            for _ in range(4):
                for w, pads, mode, value in steps:
                    xp = (F.pad(x, pads, mode="constant", value=value)
                          if mode == "constant" else F.pad(x, pads, mode=mode))
                    x = conv(xp, w)
            return x
        return run

    def device_us(fn, calls: int = 5):
        """The kernels' own time per call (``torch.profiler``'s device
        time of the ``casper_`` kernels over ``calls`` calls), without the
        host's launch path; None where the profiler sees no device."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError:
            return None
        total = sum(getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0)
                    for e in prof.key_averages() if "casper_" in e.key)
        return total / calls if total else None

    def back_to_back_ms(fn, calls: int = 10) -> float:
        """Per call over ``calls`` calls issued back to back (the host
        enqueues while the card runs)."""
        return time_ms(lambda: [fn() for _ in range(calls)]) / calls

    out = {"rows": {}}
    for label, name, boundary, shape, batch in ROWS:
        if only and not any(s in label for s in only.split(",")):
            continue
        spec = spec_of(name, boundary)
        pipe = isinstance(spec, StencilPipeline)
        pre = "pre-padded" in label
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).replace("torch.", "")
            shp = ((batch,) if batch > 1 else ()) + tuple(shape)
            g = torch.randn(shp, dtype=torch.float64, device="cuda",
                            generator=gen).to(dtype)
            isz = g.element_size()
            tile = tplan.normalize_tile(spec, None, 4, isz, shape)
            strategy = ("padded-window" if pre else tplan.ghost_strategy_for(
                spec, shape, isz, 4, tile))
            wide = tuple(4 * h for h in spec.halo)
            zero = (0,) * spec.ndim
            window = tref.pad_boundary(g, wide, spec.boundary_mode,
                                       spec.boundary_value)
            wsweep = (keng.pipeline_window_sweep if pipe
                      else keng.stencil_window_sweep)
            sweep = keng.pipeline_sweep if pipe else keng.stencil_sweep
            plain = (keng.pipeline_window_sweep_plain if pipe
                     else keng.stencil_window_sweep_plain)
            kname = ("K1" if strategy == "pad-free" else "K2") if not pipe \
                else ("K3" if strategy == "pad-free" else "K4")
            if spec.ndim == 3:
                kname += " rank 3"

            def kernel():
                return wsweep(spec, window, shape, zero, shape, tile, 4)

            fns = {
                "block": lambda: sweep(spec, g, tile, 4, strategy),
                "kernel": kernel,
                "pad": lambda: tref.pad_boundary(g, wide, spec.boundary_mode,
                                                 spec.boundary_value),
                "k1": lambda: sweep(spec, g, tile, 4, "pad-free"),
                "conv": conv_chain(spec, g),
            }
            want = plain(spec, window, shape, zero, shape, tile, 4)
            check = {}
            for key in ("block", "kernel", "k1"):
                got = fns[key]()
                err = (got.double() - want.double()).abs().max().item()
                check[key] = err == 0 if dtype == torch.float64 \
                    else err <= 1e-5
            del want
            times = {k: time_ms(fn) for k, fn in fns.items()}
            times["kernel_back_to_back"] = back_to_back_ms(kernel)
            dev = device_us(kernel)
            times["kernel_device"] = None if dev is None else dev / 1e3
            if variants and spec.ndim < 3:
                for vname, lib in libs.items():
                    if vname == "kept":
                        continue
                    _build._LIBS[keng.SOURCE] = lib
                    times[f"kernel_{vname}"] = time_ms(kernel)
                _build._LIBS[keng.SOURCE] = kept
            n_pts = math.prod(shp)
            bytes_ms = 2 * n_pts * isz / HBM_BW * 1e3
            ops_ms = (n_pts * 4 * spec.structured_flops_per_point()
                      / OPS[dname] * 1e3)
            # an older checkout packs nothing
            pack_factor = getattr(tplan, "pack_factor", None)
            pack = 1 if pack_factor is None or spec.ndim == 3 else \
                pack_factor(spec, shape, tile, 4, isz, batch, padded=True)
            out["rows"][f"{label} {dname}"] = {
                "kernel": kname, "strategy": strategy, "tile": list(tile),
                "pack": pack,
                "times": times, "equal": check,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            del g, window
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.child, args.reps, args.only,
                                not args.no_variants)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("window_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__}", flush=True)
    roots = [os.path.abspath(r) for r in (args.root or [ROOT])]
    runs = []
    for rnd in range(args.rounds):
        for root in roots:
            cmd = [sys.executable, os.path.abspath(__file__), "--child", root,
                   "--reps", str(args.reps)]
            cmd += ["--only", args.only] if args.only else []
            cmd += ["--no-variants"] if args.no_variants else []
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            tag = os.path.basename(root.rstrip("/")) or root
            for label, row in res["rows"].items():
                t = row["times"]
                print(f"round {rnd} {tag:10s} {label:56s} {row['kernel']:9s} "
                      f"tile {row['tile']} pack {row.get('pack', 1)} "
                      f"bound {row['bound_ms']:.4f} "
                      f"({row['bound_by'][:4]}) | "
                      + " ".join(f"{k} {v:.4f}" for k, v in t.items()
                                 if v is not None)
                      + f" | equal {row['equal']}", flush=True)
            runs.append({"root": root, "round": rnd, **res})
    line = json.dumps({"card": smi, "reps": args.reps, "runs": runs})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    bad = [(r["root"], k) for r in runs for k, row in r["rows"].items()
           if not all(row["equal"].values())]
    if bad:
        print(f"window_probe: not equal to the plain version: {bad}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
