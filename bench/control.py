#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference, computed in
the nearest precision below the configuration's, put in the program's
place.  It has to come out not correct.

    python3 bench/control.py --workload heat3d-f64.solve --seeds 5,6,7 \
        --out chiprun_out/control_heat3d_solve.json

For each seed it makes the cell's inputs as a run does, computes every
distinct answer the window can be due (a solve's grid) with the
reference in the configuration's precision and in the one below, and
compares them as a run compares the program's answers
(``reference/compare.py``).  Each
number is printed beside its limit.
"""
import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: The precision a control computes in, for each configured one.
LOWER = {"float64": "float32"}


def control_checks(cell, seed: int, device) -> tuple[dict, int]:
    """The checks of ``cell``'s comparison with the control's answers in
    place of the program's, on ``seed``'s inputs, and how many answers
    were compared."""
    import torch

    import harness
    from reference import compare

    ctx = harness.Context(cell, harness.stencil_spec(cell.config), seed,
                          0.0, device)
    x = cell.traffic.inputs(ctx)
    want = cell.traffic.answers(ctx, x)
    got = cell.traffic.answers(
        ctx, x.to(getattr(torch, LOWER[cell.config["dtype"]])))
    wrong, err = 0, 0.0
    for iters, ref in want.items():
        low = got[iters].to(ref.device, ref.dtype)
        if not torch.equal(low, ref):
            wrong += 1
            err = max(err, compare.max_abs_err(low, ref))
    return compare.checks(0, wrong, err), len(want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import torch

    import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload, ROOT)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        checked, n = control_checks(cell, seed, torch.device("cuda", 0))
        rows.append({"seed": seed, "answers": n, "checks": checked})
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "control": LOWER,
             "card": torch.cuda.get_device_name(0),
             "power_limit_w": harness.power_limit_w(), "rows": rows},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
