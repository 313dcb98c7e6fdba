"""Batched stencil serving on the card: heterogeneous requests through
one batched launch per bucket and block.

The counterpart of ``repro.serve.stencil``.  Requests arrive as any mix
of ``(spec-name, grid, iters)``; :class:`StencilServer`

1. **buckets** them by plan-cache key (spec, with boundary and
   structure; grid shape; dtype; backend; sweeps; tile request; device;
   budget) plus ``iters``;
2. runs each bucket as **one stacked batch** through
   :class:`repro_torch.core.plan.BatchHandle`: the grids are stacked in
   pinned host memory and uploaded once, each fused block is one launch
   for the whole bucket (the reference vmaps), and the result comes back
   in one download;
3. reports throughput, per-bucket times and the plan-cache delta
   (:class:`ServeStats`).

A bucket its plan leaves on the host (``plan.stays_on_host``: its grids
stream, or the stacked batch is over the device budget) runs on the slab
executor, in slabs or in parts, and is counted ``slab_streamed``.
Results come back as CPU tensors in request order.
``serve_sequential`` runs the same requests one by one through the
single-grid runner: the baseline the batched path is measured against.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..core import plan as _plan
from ..core.engine import resolve_device
from ..core.stencil import (PAPER_PIPELINES, PAPER_STENCILS, StencilPipeline,
                            StencilSpec, advect1d, advect2d)


def default_specs() -> dict[str, StencilSpec | StencilPipeline]:
    """The serving catalogue: the paper's six stencils, the periodic
    advection specs and the paper pipelines."""
    specs: dict[str, StencilSpec | StencilPipeline] = dict(PAPER_STENCILS)
    for s in (advect1d(), advect2d()):
        specs[s.name] = s
    specs.update(PAPER_PIPELINES)
    return specs


@dataclasses.dataclass(frozen=True)
class StencilRequest:
    """Apply ``iters`` applications of the named stencil to ``grid`` (a
    numpy array or a tensor)."""

    spec_name: str
    grid: Any
    iters: int


@dataclasses.dataclass(frozen=True)
class RequestError:
    """A structured per-request error, in the request's results slot: it
    never fails the requests served beside it."""

    spec_name: str
    error: str                  # "unknown-spec" | "rank-mismatch" |
                                # "invalid-grid" | "invalid-iters" |
                                # "shed" | "internal"
    message: str


#: Smallest denominator of a throughput: a section faster than the
#: perf_counter tick reports the highest rate the clock can see, not 0.
_CLOCK_TICK = max(float(time.get_clock_info("perf_counter").resolution),
                  1e-9)


def _throughput(count: float, seconds: float) -> float:
    return count / max(seconds, _CLOCK_TICK)


@dataclasses.dataclass
class ServeStats:
    """What one ``serve`` call (or a continuous server's window) did."""

    n_requests: int
    n_buckets: int
    seconds: float
    requests_per_s: float
    points_per_s: float
    batched: bool
    plan_cache: dict            # delta: hits/misses/lowers/autotune_calls
    buckets: list               # per bucket: spec, shape, dtype, iters,
                                # size, seconds, slab_streamed
    n_slab_streamed: int = 0    # requests whose bucket stayed on the host
    n_rejected: int = 0         # failed validation (or an internal error)
    n_shed: int = 0             # shed past the high-water mark
    n_deadline_missed: int = 0  # completed past their deadline
    latency_s: dict | None = None
                                # submit->complete percentiles (continuous
                                # server; None for one-shot calls)
    close_reasons: dict | None = None
                                # full/timeout/drain (continuous server)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _cache_delta(before: dict, after: dict) -> dict:
    delta = {k: after[k] - before[k]
             for k in ("hits", "misses", "lowers", "autotune_calls")}
    total = delta["hits"] + delta["misses"]
    delta["hit_rate"] = delta["hits"] / total if total else 1.0
    return delta


def _host_tensor(grid) -> torch.Tensor:
    if isinstance(grid, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(grid))
    return grid


class StencilServer:
    """Batched stencil serving over the plan pipeline.

    ``specs`` maps request names to specs (default: :func:`default_specs`);
    ``backend``/``sweeps``/``tile`` are the engine options every plan is
    lowered with; ``device=None`` means ``"cuda"`` (raises where CUDA is
    missing; pass ``device="cpu"`` to serve on the host)."""

    def __init__(self,
                 specs: Mapping[str, StencilSpec | StencilPipeline]
                 | None = None, *,
                 backend: str = "ref", sweeps: int = 1, tile=None,
                 device=None):
        if sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {sweeps}")
        if backend not in _plan.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.specs = default_specs() if specs is None else dict(specs)
        self.backend = backend
        self.sweeps = sweeps
        self.tile_request = _plan.canonical_tile_request(tile)
        self.device = _plan.canonical_device(resolve_device(device))

    def register(self, spec: StencilSpec | StencilPipeline) -> None:
        """Make ``spec`` servable under ``spec.name``."""
        self.specs[spec.name] = spec

    # -- admission ----------------------------------------------------------
    def validate_request(self, req: StencilRequest) -> RequestError | None:
        """``None`` when ``req`` is servable, else a :class:`RequestError`
        (never an exception)."""
        spec = self.specs.get(req.spec_name)
        if spec is None:
            return RequestError(req.spec_name, "unknown-spec",
                                f"no spec registered under "
                                f"{req.spec_name!r}")
        shape = getattr(req.grid, "shape", None)
        if shape is None or getattr(req.grid, "dtype", None) is None:
            return RequestError(req.spec_name, "invalid-grid",
                                "request grid has no shape/dtype")
        if len(shape) != spec.ndim:
            return RequestError(
                req.spec_name, "rank-mismatch",
                f"request grid rank {len(shape)} != {req.spec_name} ndim "
                f"{spec.ndim}")
        if int(req.iters) < 0:
            return RequestError(req.spec_name, "invalid-iters",
                                f"iters must be >= 0, got {req.iters}")
        return None

    # -- bucketing ----------------------------------------------------------
    def bucket_key(self, req: StencilRequest) -> tuple:
        """The request's plan-cache key plus ``iters``: requests sharing
        it run as one batch."""
        spec = self.specs[req.spec_name]
        shape, dtype = req.grid.shape, req.grid.dtype
        if len(shape) != spec.ndim:
            raise ValueError(
                f"request grid rank {len(shape)} != {req.spec_name} ndim "
                f"{spec.ndim}")
        return _plan.plan_key(spec, shape, dtype, self.backend, self.sweeps,
                              self.tile_request,
                              self.device) + (int(req.iters),)

    def _buckets(self, requests: Sequence[StencilRequest],
                 idxs: Sequence[int]) -> dict:
        buckets: dict[tuple, list[int]] = {}
        for i in idxs:
            buckets.setdefault(self.bucket_key(requests[i]), []).append(i)
        return buckets

    # -- execution ----------------------------------------------------------
    def serve(self, requests: Sequence[StencilRequest]
              ) -> tuple[list, ServeStats]:
        """Run ``requests`` (any mix of specs, shapes and iters): per
        request a CPU tensor, or a :class:`RequestError` for a request
        that fails validation, in request order, and the
        :class:`ServeStats`.  Each bucket is stacked on the host, uploaded
        once and run as one batch: one launch per fused block (a bucket's
        ``seconds`` count its staging too)."""
        before = _plan.plan_cache_stats()
        results: list = [None] * len(requests)
        valid = []
        for i, req in enumerate(requests):
            err = self.validate_request(req)
            if err is not None:
                results[i] = err
            else:
                valid.append(i)
        n_rejected = len(requests) - len(valid)
        bucket_stats = []
        points = 0
        n_slab_streamed = 0
        t0 = time.perf_counter()
        for idxs in self._buckets(requests, valid).values():
            spec = self.specs[requests[idxs[0]].spec_name]
            iters = int(requests[idxs[0]].iters)
            bh = _plan.batch_handle(spec, self.backend, self.sweeps,
                                    self.tile_request, self.device)
            tb = time.perf_counter()
            staged = bh.stage([requests[i].grid for i in idxs])
            on_host = staged.on_host
            out = bh.fetch(bh.dispatch(staged, iters))
            bucket_stats.append({
                "spec": spec.name, "shape": tuple(out.shape[1:]),
                "dtype": _plan.dtype_name(out.dtype), "iters": iters,
                "size": len(idxs), "seconds": time.perf_counter() - tb,
                "slab_streamed": on_host,
            })
            if on_host:
                n_slab_streamed += len(idxs)
            points += out.numel()
            for j, i in enumerate(idxs):
                results[i] = out[j]
        # a function of the request multiset, not of the arrival order
        bucket_stats.sort(
            key=lambda b: (b["spec"], b["shape"], b["dtype"], b["iters"]))
        seconds = time.perf_counter() - t0
        stats = ServeStats(
            n_requests=len(requests), n_buckets=len(bucket_stats),
            seconds=seconds,
            requests_per_s=_throughput(len(requests), seconds),
            points_per_s=_throughput(points, seconds), batched=True,
            plan_cache=_cache_delta(before, _plan.plan_cache_stats()),
            buckets=bucket_stats, n_slab_streamed=n_slab_streamed,
            n_rejected=n_rejected)
        return results, stats

    def serve_sequential(self, requests: Sequence[StencilRequest]
                         ) -> tuple[list, ServeStats]:
        """The per-request baseline: every request through the single-grid
        runner (:func:`repro_torch.core.plan.runner`), same plans, same
        results; validation as in :meth:`serve`."""
        before = _plan.plan_cache_stats()
        results: list = []
        points = 0
        n_rejected = 0
        t0 = time.perf_counter()
        for req in requests:
            err = self.validate_request(req)
            if err is not None:
                results.append(err)
                n_rejected += 1
                continue
            spec = self.specs[req.spec_name]
            run = _plan.runner(spec, self.backend, self.sweeps,
                               self.tile_request, self.device)
            out = run(_host_tensor(req.grid), int(req.iters)).cpu()
            points += out.numel()
            results.append(out)
        seconds = time.perf_counter() - t0
        stats = ServeStats(
            n_requests=len(requests), n_buckets=len(requests) - n_rejected,
            seconds=seconds,
            requests_per_s=_throughput(len(requests), seconds),
            points_per_s=_throughput(points, seconds), batched=False,
            plan_cache=_cache_delta(before, _plan.plan_cache_stats()),
            buckets=[], n_rejected=n_rejected)
        return results, stats
