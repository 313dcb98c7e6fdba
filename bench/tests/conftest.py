"""The benchmark's tests run on the CPU: the harness, the traffic kinds,
the readers and the reference at small sizes, the program's plain
kernel versions standing in for the card's kernels.  Tests that need the
card are marked ``cuda`` and skip themselves without one."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
