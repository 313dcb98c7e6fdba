"""Traffic kind ``solve``: one client in a closed loop, solving one large
field again and again.

Each solve is ``CasperEngine(spec, **engine).run(field, iters)`` on the
cell's seeded initial field, ended by a device synchronize; the next
starts when it returns.  The window starts solves until ``--seconds``
have passed and ends with the last one's completion, so ``update_rate``
is every solve's grid points times iterations over the whole window.

Every returned grid is fingerprinted on the device as it comes back; the
last one and one drawn from the seed (a reservoir of one) are kept
whole.  After the window, the reference solves the same field once; every
fingerprint and both kept grids must equal it bit for bit.

Cell parameters: ``level`` (a key of the configuration's ``levels``: the
grid shape) and ``iters``.
"""
from __future__ import annotations

import math
import random
import time
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from harness import seeded_rand, sync
from reference import compare
from reference import stencil as reference


def inputs(ctx) -> torch.Tensor:
    """The cell's initial field, made on the device from the seed."""
    p = ctx.cell.params
    return seeded_rand(ctx, ctx.cell.config["levels"][p["level"]])


def answers(ctx, x: torch.Tensor) -> dict:
    """Every distinct answer the window can be due: ``{iters: grid}``."""
    cfg, iters = ctx.cell.config, ctx.cell.params["iters"]
    return {iters: reference.run(x, cfg["taps"], cfg["boundary"], iters)}


def setup(ctx) -> SimpleNamespace:
    from repro_torch import CasperEngine

    cfg, p = ctx.cell.config, ctx.cell.params
    field = inputs(ctx)
    shape = tuple(field.shape)
    engine = CasperEngine(ctx.spec, device=ctx.device, **cfg["engine"])
    # the plan lowered, the kernels built and loaded, and the caching
    # allocator holding every block a solve and the kept grids take
    warm = engine.sweeps * 2 + p["iters"] % engine.sweeps
    kept = [engine.run(field, warm) for _ in range(3)]
    compare.fingerprint(kept[0])
    sync(ctx.device)
    del kept
    return SimpleNamespace(ctx=ctx, cfg=cfg, shape=shape, iters=p["iters"],
                           field=field, engine=engine)


def window(st, seconds: float, tracer) -> None:
    from repro_torch.kernels import engine as kernels

    dev = st.ctx.device
    pick = random.Random(st.ctx.seed)
    fingerprints, done_t, issue_s = [], [], 0.0
    last = sample = None
    launches = sum(kernels.LAUNCHES.values())
    with tracer.span():
        t0 = time.perf_counter()
        end = t0 + seconds
        n = 0
        while n == 0 or time.perf_counter() < end:
            a = time.perf_counter()
            with record_function("bench.solve"):
                last = st.engine.run(st.field, st.iters)
            issue_s += time.perf_counter() - a
            fingerprints.append(compare.fingerprint(last))
            with record_function("bench.sync"):
                sync(dev)
            done_t.append(time.perf_counter())
            tracer.tick()
            n += 1
            if pick.random() * n < 1:
                sample = last
        t1 = time.perf_counter()
    st.n, st.window_s, st.issue_s = n, t1 - t0, issue_s
    st.n_traced = sum(tracer.traced(t) for t in done_t)
    st.launches = sum(kernels.LAUNCHES.values()) - launches
    st.fingerprints, st.last, st.sample = fingerprints, last, sample


def finish(st) -> dict:
    """The end-to-end metrics and the readers' counters; drops the
    program's state (the engine), keeping the answers."""
    from roofline import solve_bound_s

    cfg = st.cfg
    bound, term = solve_bound_s(len(cfg["taps"]), st.shape, st.iters,
                                cfg["dtype"])
    points = math.prod(st.shape) * st.iters * st.n
    st.engine = None
    st.ctx.log(f"solve: {st.n} solves in {st.window_s:.4f} s, bound "
               f"{bound * 1e3:.4f} ms a solve ({term} term), "
               f"{st.launches} launches")
    return {"attempted": st.n,
            "end_to_end": {"update_rate": points / st.window_s / 1e9},
            "counters": {"solves": st.n, "solves_traced": st.n_traced,
                         "window_s": st.window_s,
                         "issue_s": st.issue_s, "launches": st.launches,
                         "bound_s": bound, "bound_term": term}}


def verify(st) -> dict:
    want = answers(st.ctx, st.field)[st.iters]
    fp = compare.fingerprint(want)
    wrong = int((torch.stack(st.fingerprints) != fp).sum())
    err = max(compare.max_abs_err(st.last, want),
              compare.max_abs_err(st.sample, want))
    return compare.checks(0, wrong, err)
