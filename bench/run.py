#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 bench/run.py --workload jacobi2d-f64.solve --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Set-up (inputs from the seed, the plan lowered, the kernels
built and warmed) is timed as ``setup_s``; then the cell's traffic runs
for ``--seconds``; then every answer of the window is compared with the
plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read from
a ``torch.profiler`` trace of the window), ``device`` and, last,
``checks``: each number compared beside its limit.  With no CUDA card,
too few cards, a card other than the one whose peaks the roofline holds
(``roofline.CARD``), or a JAX module loaded, it prints no result and
exits 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: Build and kernel caches, at fixed paths inside the checkout, so that
#: only a checkout's first run builds (the port keeps its nvcc libraries
#: in ``build/repro_torch/`` beside these).
CACHES = {"TRITON_CACHE_DIR": "build/bench_cache/triton",
          "CUDA_CACHE_PATH": "build/bench_cache/cuda",
          "TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import torch

    import harness
    import roofline

    cell = harness.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0)
    if card != roofline.CARD:
        print(f"the card is {card!r}; the roofline holds the peaks of "
              f"{roofline.CARD!r} alone", file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed % 2 ** 63, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            T_START, chips=cell.chips)
    found = harness.forbidden_loaded()
    if found:
        print("modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 2
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
