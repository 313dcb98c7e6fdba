"""The comparison that decides ``correct``: answers against the plain
reference, exactly.

The configurations are float64 with taps summed in a pinned order, so
the program's answer and the reference's are equal bit for bit; every
limit is 0.  The control (the reference in float32 put in the program's
place) reads above 0 on each number, as do the planted faults.
"""
from __future__ import annotations

import torch

#: Every number compared, with its limit (an exact comparison).
LIMITS = {"missing": 0, "wrong": 0, "max_abs_err": 0.0}


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """A 0-d int64 tensor on ``x``'s device: the sum of the 32-bit halves
    of every element's bit pattern.  Integer sums do not depend on the
    order of the reduction, and a grid of 2**28 elements cannot overflow
    it, so two grids equal bit for bit always give the same value."""
    return x.contiguous().view(torch.int32).sum(dtype=torch.int64)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute elementwise gap (NaN counts as infinite)."""
    d = (a.to(b.device, torch.float64) - b.to(torch.float64)).abs()
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


def checks(missing: int, wrong: int, err: float) -> dict[str, dict]:
    """The numbers compared, each beside its limit."""
    got = {"missing": missing, "wrong": wrong, "max_abs_err": err}
    return {k: {"value": got[k], "limit": LIMITS[k]} for k in LIMITS}


def passed(checked: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
