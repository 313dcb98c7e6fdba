"""Continuous-batching stencil serving on the card: admission queue, SLO
deadlines, load shedding.

The counterpart of ``repro.serve.scheduler``, around the same one-shot
front end (:class:`~repro_torch.serve.stencil.StencilServer`):

1. **Admission** — :meth:`AsyncStencilServer.submit` validates each
   request (a structured :class:`~repro_torch.serve.stencil.RequestError`
   on its handle), sheds past the ``queue_depth`` high-water mark
   (``shed_policy="reject"``: the newest arrival; open-loop clients never
   block) and appends the request to the open bucket of its plan-cache
   key and ``iters``.
2. **Bucket close** — ``"full"`` at ``max_bucket_size``, ``"timeout"``
   once its oldest request has waited ``max_wait_s``
   (:func:`repro_torch.core.perfmodel.bucket_close_wait_s` models it), or
   ``"drain"``.
3. **Execution** — the worker runs each closed bucket through
   :class:`repro_torch.core.plan.BatchHandle` on a CUDA stream of its own
   (stage into pinned host memory, upload, blocks, download), one bucket
   at a time: on the card a bucket's host work takes several times its
   device time, so a second bucket in flight would find nothing to
   overlap.  A bucket whose plan leaves it on the host (its grids stream,
   or the batch is over budget) runs on the slab executor, in slabs or in
   parts, and is counted ``slab_streamed``.
4. **Completion** — each :class:`RequestHandle` resolves with a CPU
   tensor, its latency and its deadline verdict; :meth:`stats` gives the
   window's :class:`~repro_torch.serve.stencil.ServeStats`.  A bucket
   whose launch fails fails its requests with an ``"internal"``
   :class:`RequestError`; nothing reruns elsewhere.

:func:`repro_torch.analysis.check_serve_config` runs at construction:
error findings raise, warnings warn.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
import time
import warnings
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..core import perfmodel as _pm
from ..core import plan as _plan
from ..core.stencil import StencilPipeline, StencilSpec
from .stencil import (RequestError, ServeStats, StencilRequest,
                      StencilServer, _cache_delta, _throughput)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The continuous-batching knobs, validated by
    :func:`repro_torch.analysis.check_serve_config` at server construction
    (error findings raise ``ValueError``)."""

    max_bucket_size: int = 32       # close a bucket "full" at this size
    max_wait_s: float = 0.005       # close "timeout" after the oldest
                                    # request waited this long
    queue_depth: int = 1024         # admission high-water mark: shed
                                    # arrivals past this many pending
    default_deadline_s: float | None = None
                                    # per-request SLO unless given at
                                    # submit; None: no deadline
    shed_policy: str = "reject"     # what to do past the high-water mark
    pad_buckets: bool = False       # pad each bucket with copies of row 0
                                    # to the next tier
                                    # (:func:`bucket_tiers`) and drop the
                                    # pad rows after: the grids of a batch
                                    # are independent, so the real rows
                                    # do not change.  The reference pads
                                    # by default to bound its jit
                                    # retraces; torch retraces nothing,
                                    # and padding only adds the pad rows'
                                    # work, so it is off here

    @classmethod
    def auto(cls, offered_rate_rps: float, *, max_bucket_size: int = 32,
             deadline_s: float | None = None, queue_depth: int = 1024
             ) -> "ServeConfig":
        """``max_wait_s`` from the offered load by
        :func:`repro_torch.core.perfmodel.bucket_close_wait_s`."""
        wait = _pm.bucket_close_wait_s(offered_rate_rps, max_bucket_size,
                                       deadline_s=deadline_s)
        return cls(max_bucket_size=max_bucket_size, max_wait_s=wait,
                   queue_depth=queue_depth, default_deadline_s=deadline_s)


def bucket_tiers(max_bucket_size: int) -> tuple[int, ...]:
    """The padded batch sizes: powers of two below the cap, and the
    cap."""
    tiers = []
    t = 1
    while t < max_bucket_size:
        tiers.append(t)
        t *= 2
    tiers.append(max_bucket_size)
    return tuple(tiers)


def _pad_tier(n: int, max_bucket_size: int) -> int:
    """The smallest tier >= ``n``."""
    for t in bucket_tiers(max_bucket_size):
        if t >= n:
            return t
    return max_bucket_size


class RequestRejected(RuntimeError):
    """Raised by :meth:`RequestHandle.result` for a rejected, shed or
    failed request; carries its :class:`RequestError`."""

    def __init__(self, error: RequestError):
        super().__init__(f"{error.error}: {error.message}")
        self.error = error


class RequestHandle:
    """One submitted request's future: a CPU tensor, or a structured
    :class:`RequestError`."""

    def __init__(self, request: StencilRequest, deadline_s: float | None):
        self.request = request
        self.deadline_s = deadline_s
        self._event = threading.Event()
        self._result: torch.Tensor | None = None
        self._error: RequestError | None = None
        self._submit_t: float = 0.0
        self._latency_s: float | None = None
        self._deadline_missed = False

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None) -> torch.Tensor:
        """Block until done: the result, or :class:`RequestRejected`."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.spec_name!r} not complete after "
                f"{timeout}s")
        if self._error is not None:
            raise RequestRejected(self._error)
        assert self._result is not None
        return self._result

    @property
    def error(self) -> RequestError | None:
        return self._error

    @property
    def latency_s(self) -> float | None:
        """Submit-to-complete latency (``None`` until done, and for a
        request rejected at admission)."""
        return self._latency_s

    @property
    def deadline_missed(self) -> bool:
        return self._deadline_missed

    def _reject(self, error: RequestError) -> None:
        self._error = error
        self._event.set()

    def _complete(self, result: torch.Tensor, latency_s: float) -> None:
        self._result = result
        self._latency_s = latency_s
        if self.deadline_s is not None and latency_s > self.deadline_s:
            self._deadline_missed = True
        self._event.set()


@dataclasses.dataclass
class _Bucket:
    """One forming or closed batch: one plan-cache key and ``iters``."""

    key: tuple
    spec: StencilSpec | StencilPipeline
    iters: int
    opened_t: float
    handles: list[RequestHandle] = dataclasses.field(default_factory=list)
    close_reason: str = ""


class AsyncStencilServer:
    """A long-lived continuous-batching server over the plan pipeline.

    Use as a context manager or call :meth:`start`/:meth:`stop`.
    Requests may be submitted before :meth:`start`: they queue and run
    once the worker does.  ``device=None`` means ``"cuda"``."""

    def __init__(self,
                 specs: Mapping[str, StencilSpec | StencilPipeline]
                 | None = None, *,
                 config: ServeConfig | None = None,
                 backend: str = "ref", sweeps: int = 1, tile: Any = None,
                 device=None):
        from .. import analysis as _analysis
        self.config = config or ServeConfig()
        findings = _analysis.check_serve_config(self.config)
        errors = [f for f in findings if f.severity == "error"]
        if errors:
            raise ValueError("invalid ServeConfig: "
                             + "; ".join(f.message for f in errors))
        for f in findings:
            if f.severity == "warning":
                warnings.warn(f"ServeConfig: {f.message}", stacklevel=2)
        self._front = StencilServer(specs, backend=backend, sweeps=sweeps,
                                    tile=tile, device=device)
        dev = torch.device(self._front.device)
        self._compute = (torch.cuda.Stream(dev) if dev.type == "cuda"
                         else None)
        self._cond = threading.Condition()
        self._key_memo: dict[tuple, tuple] = {}
        self._open: dict[tuple, _Bucket] = {}
        self._ready: collections.deque[_Bucket] = collections.deque()
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._cache_before = _plan.plan_cache_stats()
        self._n_submitted = 0
        self._n_completed = 0
        self._n_pending = 0
        self._n_rejected = 0
        self._n_shed = 0
        self._n_deadline_missed = 0
        self._n_slab_streamed = 0
        self._points = 0
        self._latencies: list[float] = []
        self._bucket_stats: list[dict] = []
        self._close_reasons = {"full": 0, "timeout": 0, "drain": 0}
        self._first_submit_t: float | None = None
        self._last_complete_t: float | None = None

    @property
    def specs(self) -> dict[str, StencilSpec | StencilPipeline]:
        return self._front.specs

    @property
    def device(self) -> str:
        return self._front.device

    def register(self, spec: StencilSpec | StencilPipeline) -> None:
        with self._cond:
            self._front.register(spec)
            self._key_memo.clear()      # the name may now mean a new spec

    # -- lifecycle ----------------------------------------------------------
    def _start_worker_locked(self) -> None:
        self._thread = threading.Thread(target=self._worker,
                                        name="casper-serve", daemon=True)
        self._thread.start()

    def start(self) -> "AsyncStencilServer":
        """Start the worker thread (idempotent)."""
        with self._cond:
            if self._stopping:
                raise RuntimeError("server already stopped")
            if self._thread is None:
                self._start_worker_locked()
        return self

    def stop(self, timeout: float | None = None) -> None:
        """Drain everything queued, then stop the worker (idempotent):
        every admitted request completes before ``stop`` returns.  Raises
        ``TimeoutError`` if the worker is still running after ``timeout``
        seconds (``None``: wait as long as it takes)."""
        with self._cond:
            already = self._stopping
            self._stopping = True
            self._cond.notify_all()
            if not already and self._thread is None:
                self._start_worker_locked()     # drain what was queued
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"serving worker still running after "
                                   f"{timeout}s")

    def drain(self, timeout: float | None = None) -> None:
        """Close every open bucket (``"drain"``) and wait until every
        admitted request has completed; the server keeps running.  Raises
        ``TimeoutError`` if requests are still pending after ``timeout``
        seconds (``None``: wait as long as it takes)."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            if self._thread is None:
                raise RuntimeError("server not started")
            self._close_all_locked("drain")
            self._cond.notify_all()
            while self._n_pending > 0 and self._thread.is_alive():
                left = 0.1 if end is None else min(
                    end - time.perf_counter(), 0.1)
                if left <= 0:
                    raise TimeoutError(
                        f"{self._n_pending} requests still pending after "
                        f"{timeout}s")
                self._cond.wait(timeout=left)

    def __enter__(self) -> "AsyncStencilServer":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def warmup(self, requests: Sequence[StencilRequest]) -> int:
        """Run every tier (:func:`bucket_tiers`) of every bucket key in
        ``requests`` once: the plans are lowered, the kernels built and
        tuned, and the host allocator holds a pinned block of each size
        class a bucket can ask for (it rounds a block up to a power of
        two), padded or not, before live traffic.  Returns the
        ``(bucket key, tier)`` combinations run."""
        exemplars: dict[tuple, StencilRequest] = {}
        for req in requests:
            if self._front.validate_request(req) is None:
                exemplars.setdefault(self._front.bucket_key(req), req)
        tiers = bucket_tiers(self.config.max_bucket_size)
        n = 0
        with self._stream_ctx():
            for req in exemplars.values():
                bh = self._handle(self.specs[req.spec_name])
                for tier in tiers:
                    staged = bh.stage([req.grid] * tier)
                    bh.fetch(bh.dispatch(staged, int(req.iters)))
                    n += 1
                    if staged.plan.needs_host_streaming:
                        break           # streams grid by grid: one tier
        return n

    # -- admission ----------------------------------------------------------
    def submit(self, request: StencilRequest, *,
               deadline_s: float | None = None) -> RequestHandle:
        """Admit one request; a bad or shed request resolves its handle at
        once with a :class:`RequestError`, never raises.  ``deadline_s``
        overrides the config's default SLO."""
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        handle = RequestHandle(request, deadline_s)
        err = self._front.validate_request(request)
        now = time.perf_counter()
        with self._cond:
            if self._stopping:
                raise RuntimeError("server stopped")
            self._n_submitted += 1
            if self._first_submit_t is None:
                self._first_submit_t = now
            if err is not None:
                self._n_rejected += 1
                handle._reject(err)
                return handle
            if self._n_pending >= self.config.queue_depth:
                self._n_shed += 1
                handle._reject(RequestError(
                    request.spec_name, "shed",
                    f"queue past high-water mark ({self._n_pending} "
                    f"pending >= queue_depth {self.config.queue_depth})"))
                return handle
            handle._submit_t = now
            self._n_pending += 1
            memo = (request.spec_name, tuple(request.grid.shape),
                    str(request.grid.dtype), int(request.iters))
            key = self._key_memo.get(memo)
            if key is None:
                key = self._key_memo[memo] = self._front.bucket_key(request)
            bucket = self._open.get(key)
            wake = False
            if bucket is None:
                bucket = _Bucket(key=key, spec=self.specs[request.spec_name],
                                 iters=int(request.iters), opened_t=now)
                self._open[key] = bucket
                wake = True             # the worker re-arms its timer
            bucket.handles.append(handle)
            if len(bucket.handles) >= self.config.max_bucket_size:
                self._close_locked(bucket, "full")
                wake = True
            if wake:
                self._cond.notify_all()
        return handle

    # -- bucket lifecycle (under self._cond) --------------------------------
    def _close_locked(self, bucket: _Bucket, reason: str) -> None:
        bucket.close_reason = reason
        self._close_reasons[reason] += 1
        del self._open[bucket.key]
        self._ready.append(bucket)

    def _close_expired_locked(self, now: float) -> None:
        for bucket in list(self._open.values()):
            if now - bucket.opened_t >= self.config.max_wait_s:
                self._close_locked(bucket, "timeout")

    def _close_all_locked(self, reason: str) -> None:
        for bucket in list(self._open.values()):
            self._close_locked(bucket, reason)

    def _next_bucket(self) -> _Bucket | None:
        """The next closed bucket, waiting at most until the earliest open
        bucket's close time between checks; ``None`` once stopping with
        nothing left."""
        with self._cond:
            while True:
                self._close_expired_locked(time.perf_counter())
                if self._ready:
                    return self._ready.popleft()
                if self._stopping:
                    if self._open:
                        self._close_all_locked("drain")
                        continue
                    return None
                timeout = None
                if self._open:
                    earliest = min(b.opened_t for b in self._open.values())
                    timeout = max(earliest + self.config.max_wait_s
                                  - time.perf_counter(), 0.0)
                self._cond.wait(timeout=timeout)

    # -- execution ----------------------------------------------------------
    def _handle(self, spec) -> _plan.BatchHandle:
        return _plan.batch_handle(spec, self._front.backend,
                                  self._front.sweeps,
                                  self._front.tile_request, self.device)

    def _stream_ctx(self):
        """The worker's compute stream, set explicitly: the kernels launch
        on the current stream."""
        if self._compute is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._compute)

    def _worker(self) -> None:
        try:
            with self._stream_ctx():
                while (bucket := self._next_bucket()) is not None:
                    self._run_bucket(bucket)
        finally:
            with self._cond:
                self._cond.notify_all()

    def _run_bucket(self, bucket: _Bucket) -> None:
        """Stage, dispatch and fetch one bucket; a failure anywhere fails
        its requests ``"internal"``."""
        try:
            bh = self._handle(bucket.spec)
            grids = [h.request.grid for h in bucket.handles]
            if self.config.pad_buckets:
                tier = _pad_tier(len(grids), self.config.max_bucket_size)
                grids = grids + [grids[0]] * (tier - len(grids))
            staged = bh.stage(grids)
            t_dispatch = time.perf_counter()
            out = bh.fetch(bh.dispatch(staged, bucket.iters))
        except Exception as exc:                    # noqa: BLE001
            self._fail_bucket(bucket, exc)
            return
        self._record(bucket, out.unbind(0), tuple(out.shape[1:]), out.dtype,
                     time.perf_counter() - t_dispatch, staged.stage_ms,
                     slab=staged.on_host, padded=out.shape[0])

    def _record(self, bucket: _Bucket, outs: list, shape, dtype,
                seconds: float, stage_ms: float, *, slab: bool,
                padded: int) -> None:
        now = time.perf_counter()
        with self._cond:
            for handle, out in zip(bucket.handles, outs):
                handle._complete(out, now - handle._submit_t)
                if handle.deadline_missed:
                    self._n_deadline_missed += 1
                self._latencies.append(now - handle._submit_t)
            self._points += len(bucket.handles) * math.prod(shape)
            self._n_pending -= len(bucket.handles)
            self._n_completed += len(bucket.handles)
            if slab:
                self._n_slab_streamed += len(bucket.handles)
            self._last_complete_t = now
            self._bucket_stats.append({
                "spec": bucket.spec.name, "shape": tuple(shape),
                "dtype": _plan.dtype_name(dtype), "iters": bucket.iters,
                "size": len(bucket.handles), "seconds": seconds,
                "slab_streamed": slab, "close_reason": bucket.close_reason,
                "padded_size": padded, "stage_ms": stage_ms,
                "seq": len(self._bucket_stats),
            })
            self._cond.notify_all()

    def _fail_bucket(self, bucket: _Bucket, exc: BaseException) -> None:
        with self._cond:
            for handle in bucket.handles:
                handle._reject(RequestError(
                    handle.request.spec_name, "internal",
                    f"{type(exc).__name__}: {exc}"))
            self._n_pending -= len(bucket.handles)
            self._n_rejected += len(bucket.handles)
            self._cond.notify_all()

    # -- reporting ----------------------------------------------------------
    def stats(self) -> ServeStats:
        """The window since construction: throughput over the first
        submit to the last completion, latency percentiles, shed, reject
        and deadline counts, close reasons and the plan-cache delta;
        bucket stats sorted by bucket identity."""
        with self._cond:
            latencies = list(self._latencies)
            if (self._first_submit_t is not None
                    and self._last_complete_t is not None):
                seconds = max(self._last_complete_t - self._first_submit_t,
                              0.0)
            else:
                seconds = 0.0
            buckets = sorted(
                self._bucket_stats,
                key=lambda b: (b["spec"], b["shape"], b["dtype"],
                               b["iters"], b["size"], b["close_reason"]))
            return ServeStats(
                n_requests=self._n_submitted, n_buckets=len(buckets),
                seconds=seconds,
                requests_per_s=_throughput(self._n_completed, seconds),
                points_per_s=_throughput(self._points, seconds),
                batched=True,
                plan_cache=_cache_delta(self._cache_before,
                                        _plan.plan_cache_stats()),
                buckets=buckets, n_slab_streamed=self._n_slab_streamed,
                n_rejected=self._n_rejected, n_shed=self._n_shed,
                n_deadline_missed=self._n_deadline_missed,
                latency_s=_latency_summary(latencies),
                close_reasons=dict(self._close_reasons))


def _latency_summary(latencies: Sequence[float]) -> dict | None:
    """p50/p95/p99/max/mean of submit-to-complete latencies."""
    if not latencies:
        return None
    arr = np.asarray(latencies, dtype=np.float64)
    return {"p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99)),
            "max": float(arr.max()), "mean": float(arr.mean())}
