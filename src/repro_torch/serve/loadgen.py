"""Open-loop load generation for the continuous-batching server.

A copy of ``repro.serve.loadgen``: arrivals follow a seeded Poisson
process and are submitted on schedule whether or not the server keeps up,
so saturation shows as queue latency and shed requests.  The same numpy
draws as the reference, so the same ``(n, seed, dtype)`` gives the same
request multiset (numpy grids; the server stacks them on the host).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from .scheduler import AsyncStencilServer, RequestHandle
from .stencil import StencilRequest


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """Submit ``request`` at ``at_s`` seconds after the run starts."""

    at_s: float
    request: StencilRequest


def mixed_requests(n: int = 64, seed: int = 7,
                   dtype=np.float32) -> list[StencilRequest]:
    """The reference's serving mix (BENCH_5's 48:8:6:2 proportions) at
    ``n`` requests: three quarters ``jacobi2d (32, 64)``, plus
    ``advect2d (32, 64)``, ``jacobi1d (512,)`` and ``heat3d (8, 12, 16)``;
    deterministic in ``seed``."""
    rng = np.random.default_rng(seed)

    def grid(shape):
        return rng.standard_normal(shape).astype(dtype)

    counts = {
        "jacobi2d": max(n - (n // 8 + max(n // 11, 1) + max(n // 32, 1)),
                        1),
        "advect2d": n // 8,
        "jacobi1d": max(n // 11, 1),
        "heat3d": max(n // 32, 1),
    }
    shapes = {"jacobi2d": (32, 64), "advect2d": (32, 64),
              "jacobi1d": (512,), "heat3d": (8, 12, 16)}
    iters = {"jacobi2d": 8, "advect2d": 8, "jacobi1d": 6, "heat3d": 4}
    reqs = [StencilRequest(name, grid(shapes[name]), iters[name])
            for name, count in counts.items() for _ in range(count)]
    order = rng.permutation(len(reqs))
    return [reqs[i] for i in order]


def poisson_times(n: int, rate_rps: float, seed: int = 0) -> np.ndarray:
    """``n`` Poisson arrival offsets (seconds, ascending) at
    ``rate_rps``."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def poisson_workload(requests: Sequence[StencilRequest], rate_rps: float,
                     seed: int = 0) -> list[TimedRequest]:
    """``requests`` (in order) on a seeded Poisson schedule."""
    times = poisson_times(len(requests), rate_rps, seed)
    return [TimedRequest(float(t), r) for t, r in zip(times, requests)]


def submit_open_loop(server: AsyncStencilServer,
                     workload: Sequence[TimedRequest], *,
                     deadline_s: float | None = None
                     ) -> list[RequestHandle]:
    """Submit ``workload`` on its schedule (never waiting on the server),
    returning the handles in submission order."""
    handles = []
    t0 = time.perf_counter()
    for timed in workload:
        # sleep only for coarse waits and spin out the sub-millisecond
        # rest: a sleep overshoots by tens of microseconds, longer than
        # the gap between arrivals at a high offered load.  The spin
        # yields the GIL on every turn (``sleep(0)``): the server's worker
        # is a thread of this process, and a bare spin holds the GIL for
        # a whole switch interval (5 ms) each time the worker returns from
        # a call that released it (the reference spins bare)
        while True:
            delay = timed.at_s - (time.perf_counter() - t0)
            if delay <= 0:
                break
            time.sleep(delay - 5e-4 if delay > 1e-3 else 0)
        handles.append(server.submit(timed.request, deadline_s=deadline_s))
    return handles
