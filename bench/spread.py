#!/usr/bin/env python3
"""Run one cell several times, each run a process of its own as the
benchmark's command runs it, and report each metric's spread.

    python3 bench/spread.py --workload heat3d-f64.solve --seeds 11,12,13 \
        --seconds 20 --out chiprun_out/spread_heat3d_solve.json

For every run it keeps the exit code, the wall time, the result line and
the end of standard error.  For every metric it gives the values, the
median and the spread: the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) as a share of the
median.  ``--seconds`` defaults to ``run_seconds`` of ``BENCHMARK.json``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
            "run_seconds"]
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(BENCH / "run.py"), "--workload",
               args.workload, "--seed", seed, "--seconds", str(seconds),
               "--trace", str(args.trace)]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=ROOT)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            line = None
        runs.append({"seed": int(seed), "rc": proc.returncode,
                     "wall_s": wall, "line": line,
                     "stderr_tail": proc.stderr[-3000:]})
        brief = {k: v["value"] for k, v in (line or {}).get(
            "metrics", {}).items()}
        print(json.dumps({"seed": int(seed), "rc": proc.returncode,
                          "wall_s": round(wall, 2),
                          "correct": (line or {}).get("correct"),
                          "metrics": brief}), flush=True)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
    names = sorted({k for r in runs if r["line"]
                    for k in r["line"]["metrics"]})
    summary = {}
    for name in names:
        vals = [r["line"]["metrics"][name]["value"] for r in runs
                if r["line"] and name in r["line"]["metrics"]
                and r["line"]["metrics"][name]["value"] is not None]
        summary[name] = {"values": vals,
                         "median": statistics.median(vals) if vals else None,
                         "spread": spread(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "seconds": seconds,
             "runs": runs, "summary": summary}, indent=1))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
