"""Run some of chip_smoke.py's LM cases, or its phase 2l, alone on the
card, from a checkout, and write their records.

    python3 tools/lm_phases.py --cases qwen3_cases,gemma2_cases,\\
        qwen3_train_case [--root DIR] [--out chiprun_out/lm_phases.json]
    python3 tools/lm_phases.py --cases sharded_phase

Each case is one of chip_smoke.py's phase 2j/2k case functions (called
as ``case(failures, smi, rates)``) or ``sharded_phase`` (2l).
``--root`` (default: this checkout) names the checkout whose
``chip_smoke.py`` and ``src/`` run: to time two commits on one card in
one call, unpack the other with ``git archive`` into a directory that
.gitignore lists and run the two in turn (A, B, B, A).  Prints the card,
each case's served models' prefill ms and median decode ms a step and
each trained model's median step ms; exits 1 if a check failed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = ("prefill_ms", "decode_ms_median", "step_ms_median")


def times(rec, path=""):
    """(path, key, value) of every time in a case's record."""
    if isinstance(rec, dict):
        for k, v in rec.items():
            if k in TIMES and isinstance(v, (int, float)):
                yield path, k, v
            else:
                yield from times(v, f"{path}/{k}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", required=True)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)         # puts root/src first on sys.path
    torch = cs.torch
    if not torch.cuda.is_available():
        print("lm_phases: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _, rate = cs.card_rates(torch.cuda.get_device_name(0))
    rates = {"bytes": rate[0], "bf16": rate[3], "f32": rate[2]}
    print(f"card: {smi} | root {root} | torch {torch.__version__}",
          flush=True)
    failures, records = [], {}
    for name in args.cases.split(","):
        t0 = time.time()
        torch.cuda.empty_cache()
        fn = getattr(cs, name)
        records[name] = (fn(failures, smi) if name == "sharded_phase"
                         else fn(failures, smi, rates))
        print(f"{name}: {time.time() - t0:.1f}s", flush=True)
        for path, key, value in times(records[name]):
            print(f"  {path} {key} {value}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "root": root, "records": records,
                       "failures": failures}, fh, indent=1, default=str)
    for f in failures:
        print(f"FAILED: {f}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
