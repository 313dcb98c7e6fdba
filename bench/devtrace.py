"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics and the breakdown read.

A traced run wraps the traced part of its window in a ``bench.window``
annotation; the device's busy time is the union of its kernels, copies
and memsets clipped to that span.  Idle gaps are named by the innermost
host event running at their midpoint.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import tempfile
import time
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: How many entries each list of the breakdown keeps.
TOP = 10
#: How far back from a gap's midpoint the search for its host event goes.
_LOOKBACK = 4000


class Tracer:
    """The window's trace.  ``span()`` wraps the measured window; when
    tracing is on, a ``torch.profiler`` session over CPU and CUDA covers
    its first ``limit_s`` seconds, inside a ``bench.window`` annotation.
    A traffic kind calls ``tick()`` as it goes, which ends the trace once
    ``limit_s`` have passed (a long window's trace would take minutes to
    read); ``t_stop`` is then the host clock at its end, and work done
    after it is not in the trace."""

    def __init__(self, on: bool, limit_s: float = math.inf):
        self.on = on
        self.limit_s = limit_s
        self.prof = None
        self.t0 = self.t_stop = None
        self._span = None

    @contextlib.contextmanager
    def span(self):
        if self.on:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self._span = record_function(WINDOW)
            self._span.__enter__()
        self.t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.stop()

    def tick(self) -> None:
        if (self._span is not None
                and time.perf_counter() - self.t0 >= self.limit_s):
            self.stop()

    def stop(self) -> None:
        if self._span is None:
            return
        self._span.__exit__(None, None, None)
        self._span = None
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def traced(self, t: float) -> bool:
        """Whether host time ``t`` falls before the trace ended."""
        return self.t_stop is None or t <= self.t_stop


def events(prof) -> list[dict]:
    """The complete events of a finished profiler session, through its
    chrome trace in a temporary file that is removed after."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            raw = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    return [e for e in raw if e.get("ph") == "X" and "dur" in e]


def union(iv):
    """Merged, sorted intervals of ``iv``."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """One traced window: device intervals, the window's span and the
    host events, in microseconds of the trace's clock."""

    def __init__(self, evs: list[dict]):
        self.device = [e for e in evs if e.get("cat") in DEVICE_CATS]
        spans = [e for e in evs if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"trace has no {WINDOW!r} span")
        w = spans[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in evs
                      if e.get("cat") in HOST_CATS and e["name"] != WINDOW)
        self._host = host
        self._host_starts = [h[0] for h in host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _busy(self):
        iv = []
        for e in self.device:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b > a:
                iv.append((a, b))
        return union(iv)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) / 1e6

    def kernel_s(self, prefix: str) -> float:
        """Summed duration of every kernel whose name (after a ``void``
        return type) starts with ``prefix``, over the whole trace."""
        total = 0.0
        for e in self.device:
            name = e["name"]
            if name.startswith("void "):
                name = name[5:]
            if e.get("cat") == "kernel" and name.startswith(prefix):
                total += float(e["dur"])
        return total / 1e6

    def device_ops(self) -> list[list]:
        """The device operations that took most time: ``[name, s]``."""
        by = defaultdict(float)
        for e in self.device:
            by[e["name"][:120]] += float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self._host_starts, t)
        for j in range(i - 1, max(i - 1 - _LOOKBACK, -1), -1):
            a, b, name = self._host[j]
            if b >= t:
                return name
        return "host: no traced op"

    def idle_gaps(self) -> list[list]:
        """Idle time inside the window by the host's activity in it:
        ``[name, s]``, the largest totals first."""
        busy = self._busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        by = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                by[self._host_at((a + b) / 2)] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:TOP]]
