"""The program's own spans in a traced window: the ``record_function``
ranges the port opens while the profiler records (``casper.run``,
``casper.block``, ``casper.launch``, ...; ``repro_torch.tracing``).  A
program without them leaves the readers nothing to read."""
from __future__ import annotations


def within(trace, name: str) -> list[tuple[float, float]]:
    """``(start, end)`` in microseconds of every host span ``name`` that
    starts inside the window's ``bench.window`` span."""
    return [(a, b) for a, b, n in trace._host
            if n == name and trace.t0 <= a < trace.t1]


def mean_us(rec, name: str) -> float | None:
    """The mean length of the window's spans ``name`` in microseconds,
    or ``None`` without a trace or such a span."""
    if rec.trace is None:
        return None
    iv = within(rec.trace, name)
    if not iv:
        return None
    return sum(b - a for a, b in iv) / len(iv)
