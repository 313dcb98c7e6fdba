"""Time the stencil entries K1/K2 on the rank-3 and periodic cases on one GPU.

    python3 tools/rank3_probe.py [--root DIR ...] [--reps N] [--rounds N] [--out FILE]
        [--only SUBSTR,...]

Each ``--root`` is the root of a checkout whose ``src/repro_torch`` is
timed (default: this one); several roots are timed in turns, ``--rounds``
times over (``--root A --root B --rounds 2`` gives A, B, A, B), each in
its own subprocess, so that two versions of the kernel are compared
within one call on one card.  Cases, f64, CUDA-event medians:

* star33_3d (zero) at 256x256x64 on K1 at sweeps 1, 2 and 4: the block
  time per application separates the halo recompute (which grows with
  sweeps) from the per-point work;
* periodic grids on K1 (pad-free, no host pad) against K2 with the host
  ``pad_boundary`` gather (padded-window), forced both ways: jacobi2d
  2048^2 and 8192^2, blur2d 2048^2, star33_3d and heat3d 256x256x64, and
  the non-fusable advect2d -> rd_react chain at 2048^2 run staged with
  the periodic whole-grid budget forced to 0 (K2 + pad for the periodic
  stage) and to the device budget (K1 for both stages), beside its
  ``F.pad`` + ``F.conv2d`` chain (cuDNN, TF32 off; never called by the
  port);
* heat3d at 512x512x256 on K1 (zero), sweeps=4;
* heat3d at 32x512x512 (zero, sweeps=4), a grid shallower than a
  32-plane chunk's window, on the kernel and tile the plan picks (the
  default tile, strategy from ``ghost_strategy_for``);
* with ``--tiles``, K1 on star33_3d 256x256x64 and heat3d 512x512x256
  (zero, sweeps=4) at explicit tiles: the xy tile against the halo it
  recomputes and the z chunk against the CTA count (this checkout's
  root only: another checkout's kernel may not take the tiles).

``--only`` times just the cases whose label holds one of the given
substrings.  Every pair is checked bitwise equal.  Prints the card's name and power
limit; the last line is one JSON object with every number (``--out``
writes it too).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


STAR_TILES = ((32, 16, 32), (16, 16, 32), (64, 16, 32), (32, 16, 16),
              (64, 16, 16), (32, 8, 32), (32, 8, 16))
HEAT_TILES = ((32, 32, 32), (64, 32, 32), (16, 32, 32), (32, 16, 32),
              (32, 16, 64))


def _child(root: str, reps: int, tiles: bool, only: str | None) -> dict:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS, StencilPipeline
    from repro_torch.core import perfmodel as pm
    from repro_torch.kernels import engine as keng

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(20211228)

    def randn(*shape):
        return torch.randn(shape, dtype=torch.float64, device="cuda",
                           generator=gen)

    def wanted(label: str) -> bool:
        return not only or any(sub in label for sub in only.split(","))

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

    out: dict = {"times": {}, "equal": {}}
    st = PAPER_STENCILS
    cube, big, mid = randn(256, 256, 64), randn(8192, 8192), randn(2048, 2048)
    star = st["star33_3d"]
    for sweeps in (1, 2, 4):
        label = f"K1 star33_3d zero 256x256x64 s{sweeps}"
        if wanted(label):
            out["times"][label] = time_ms(
                lambda s=sweeps: keng.stencil_sweep(star, cube, None, s,
                                                    "pad-free"))
    periodic = [("jacobi2d 2048^2", st["jacobi2d"], mid),
                ("jacobi2d 8192^2", st["jacobi2d"], big),
                ("blur2d 2048^2", st["blur2d"], mid),
                ("star33_3d 256x256x64", star, cube),
                ("heat3d 256x256x64", st["heat3d"], cube)]
    for label, spec, g in periodic:
        if not wanted(f"{label} periodic"):
            continue
        spec = spec.with_boundary("periodic")
        runs = {k: (lambda k=k, spec=spec, g=g:
                    keng.stencil_sweep(spec, g, None, 4, k))
                for k in ("pad-free", "padded-window")}
        out["equal"][label] = torch.equal(runs["pad-free"](),
                                          runs["padded-window"]())
        for k, fn in runs.items():
            out["times"][f"{label} periodic {k}"] = time_ms(fn)
    shallow = randn(32, 512, 512)
    label = "heat3d zero 32x512x512 s4 (plan's tile and kernel)"
    if wanted(label):
        out["times"][label] = time_ms(
            lambda: keng.stencil_sweep(st["heat3d"], shallow, None, 4))
        out["equal"][label] = torch.equal(
            keng.stencil_sweep(st["heat3d"], shallow, None, 4),
            keng.stencil_sweep(st["heat3d"], shallow, None, 4,
                               "padded-window"))
    del shallow
    if not wanted("advect_react"):
        return _rest(out, st, keng, randn, time_ms, wanted, tiles, star)
    rd = PAPER_PIPELINES["reaction_diffusion2d"]
    chain = StencilPipeline("advect_react", (
        PAPER_PIPELINES["advect_diffuse2d"].stages[0], rd.stages[1]))
    saved = pm.PERIODIC_WHOLE_GRID_BYTES
    results = {}
    for label, budget in (("K2 + pad", 0), ("K1", pm.slab_budget_bytes())):
        pm.PERIODIC_WHOLE_GRID_BYTES = budget

        def staged():
            return keng.pipeline_sweep(chain, mid, None, 4, "staged")
        results[label] = staged()
        out["times"][f"advect_react 2048^2 staged {label}"] = time_ms(staged)
    pm.PERIODIC_WHOLE_GRID_BYTES = saved
    out["equal"]["advect_react 2048^2"] = torch.equal(*results.values())
    steps = []
    for s in chain.stages:
        w = torch.zeros([1, 1] + [2 * h + 1 for h in s.halo],
                        dtype=torch.float64, device="cuda")
        for off, c in s.taps:
            w[(0, 0) + tuple(h + o for h, o in zip(s.halo, off))] = c
        mode = {"periodic": "circular", "reflect": "reflect"}[s.boundary_mode]
        steps.append((w, [s.halo[1]] * 2 + [s.halo[0]] * 2, mode))

    def conv():
        x = mid.reshape(1, 1, *mid.shape)
        for _ in range(4):
            for w, pads, mode in steps:
                x = F.conv2d(F.pad(x, pads, mode=mode), w)
        return x
    out["times"]["advect_react 2048^2 F.pad + F.conv2d"] = time_ms(conv)
    return _rest(out, st, keng, randn, time_ms, wanted, tiles, star)


def _rest(out, st, keng, randn, time_ms, wanted, tiles, star) -> dict:
    """The 512x512x256 cases and the tiles, after the 2-D ones' grids are
    freed."""
    import torch
    torch.cuda.empty_cache()
    cube = randn(512, 512, 256)
    label = "K1 heat3d zero 512x512x256 s4"
    if wanted(label):
        out["times"][label] = time_ms(
            lambda: keng.stencil_sweep(st["heat3d"], cube, None, 4,
                                       "pad-free"))
    if tiles:
        def tiled(label, spec, g, t):
            # a tile whose shared memory does not fit is refused: skipped
            try:
                keng.stencil_sweep(spec, g, t, 4, "pad-free")
            except ValueError:
                return
            out["times"][f"{label} tile {t}"] = time_ms(
                lambda: keng.stencil_sweep(spec, g, t, 4, "pad-free"))
        for t in HEAT_TILES:
            tiled("K1 heat3d zero 512x512x256 s4", st["heat3d"], cube, t)
        del cube
        cube = randn(256, 256, 64)
        for t in STAR_TILES:
            tiled("K1 star33_3d zero 256x256x64 s4", star, cube, t)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--only")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.child, args.reps, args.tiles,
                                args.only)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("rank3_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    roots = [os.path.abspath(r) for r in (args.root or [ROOT])]
    runs = []
    for rnd in range(args.rounds):
        for root in roots:
            tiles = ["--tiles"] if args.tiles and root == ROOT else []
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--child", root, "--reps", str(args.reps)]
                                  + tiles
                                  + (["--only", args.only] if args.only
                                     else []),
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for label, ms in res["times"].items():
                print(f"round {rnd} {os.path.basename(root):12s} {label:52s} "
                      f"{ms:9.4f} ms", flush=True)
            print(f"round {rnd} {os.path.basename(root)} bitwise equal: "
                  f"{res['equal']}", flush=True)
            runs.append({"root": root, "round": rnd, **res})
    line = json.dumps({"card": smi, "reps": args.reps, "runs": runs})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    bad = [r["root"] for r in runs if not all(r["equal"].values())]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
