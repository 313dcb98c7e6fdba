"""The yardstick's roofline: published peaks and the least time a stencil
solve can take on one card.

The work is the algorithm's, not the kernel's: each grid point costs two
operations per tap and iteration (one multiply, one add), and the grid is
read once and written once over the whole solve, whatever a kernel reads
again or however it fuses its sweeps.  So the bound stays the same
whichever kernel a later change puts on the path.
"""
from __future__ import annotations

import math

#: The one card the benchmark runs on, as ``torch.cuda.get_device_name``
#: gives it, and its peaks: the NVIDIA H100 SXM5 80GB data sheet, dense
#: rates, at its 700 W limit.
CARD = "NVIDIA H100 80GB HBM3"
PEAKS = {"float64": 34e12, "float32": 67e12, "hbm_bytes_per_s": 3.35e12}

ITEMSIZE = {"float64": 8, "float32": 4}


def solve_work(n_taps: int, shape, iters: int, dtype: str) -> dict:
    """Operations and compulsory bytes of one solve of ``iters``
    applications of an ``n_taps`` stencil to a ``shape`` grid."""
    points = math.prod(shape)
    return {"flops": 2 * n_taps * points * iters,
            "bytes": 2 * ITEMSIZE[dtype] * points}


def solve_bound_s(n_taps: int, shape, iters: int,
                  dtype: str) -> tuple[float, str]:
    """The least time of one solve and the term that sets it
    (``"compute"`` or ``"memory"``)."""
    w = solve_work(n_taps, shape, iters, dtype)
    compute = w["flops"] / PEAKS[dtype]
    memory = w["bytes"] / PEAKS["hbm_bytes_per_s"]
    return (compute, "compute") if compute >= memory else (memory, "memory")
