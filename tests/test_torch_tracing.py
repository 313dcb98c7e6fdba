"""The port's spans (``repro_torch.tracing``) and its set-up timers.

* with no profiler recording, ``span()`` is one shared no-op and never
  touches the profiler's record functions;
* under ``torch.profiler``, one cold ``CasperEngine.run`` leaves
  ``casper.run`` ⊃ ``casper.place`` ⊃ ``casper.lower`` ⊃
  ``casper.verify``, a ``casper.block`` per fused block and one for the
  remainder, and the remainder's own ``casper.lower``; a warm run lowers
  nothing;
* ``PlanCache``'s ``lower_s`` and ``analysis.counters()["seconds"]`` grow
  on a miss, not on a hit, and are zeroed by their ``clear``.

``casper.launch`` wraps the CUDA kernels' launch, which the CPU never
reaches (the plain versions run there); the benchmark's traced runs
read it on the card.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import PAPER_STENCILS, CasperEngine, analysis, tracing
from repro_torch.core import plan as tplan


@pytest.fixture
def cold():
    """An empty plan cache and report cache, verification on."""
    tplan.PLAN_CACHE.clear()
    analysis.clear_reports()
    analysis.set_verify_mode("warn")
    yield
    analysis.set_verify_mode(None)


def _engine():
    return CasperEngine(PAPER_STENCILS["jacobi2d"], backend="cuda",
                        device="cpu", sweeps=4)


def _grid():
    return torch.rand((64, 64), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(3))


def _spans(prof, tmp_path) -> list[tuple[str, float, float]]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                  for e in evs if e.get("ph") == "X"
                  and e.get("name", "").startswith("casper."))


def _inside(inner, outer) -> bool:
    eps = 1e-2       # the chrome trace's microseconds, rounded
    return outer[1] - eps <= inner[1] and inner[2] <= outer[2] + eps


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _raise(*args, **kwargs):
    raise AssertionError("a torch profiler call with no profiler recording")


def test_span_off_is_one_shared_noop(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", _raise)
    first = tracing.span("casper.run")
    assert tracing.span("casper.block") is first
    with first:
        with tracing.span("casper.launch"):
            pass
    # the whole solve path, untraced, never enters record_function
    out = _engine().run(_grid(), iters=5)
    assert out.shape == (64, 64)


def test_cold_run_nests_its_spans(cold, tmp_path):
    eng, grid = _engine(), _grid()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(grid, iters=10)
    spans = _spans(prof, tmp_path)
    (run,) = _named(spans, "casper.run")
    (place,) = _named(spans, "casper.place")
    lowers = _named(spans, "casper.lower")
    verifies = _named(spans, "casper.verify")
    blocks = _named(spans, "casper.block")
    assert tplan.PLAN_CACHE.stats()["lowers"] == 2
    assert len(lowers) == 2 and len(verifies) == 2
    assert _inside(place, run)
    first = [s for s in lowers if _inside(s, place)]
    assert len(first) == 1
    assert any(_inside(v, first[0]) for v in verifies)
    # decompose(10) == (2, 2): two fused blocks and the remainder
    assert eng.plan_for((64, 64), torch.float64).decompose(10) == (2, 2)
    assert len(blocks) == 3
    assert all(_inside(b, run) and not _inside(b, place) for b in blocks)
    # the remainder's plan is lowered inside the run, past placement
    (second,) = [s for s in lowers if s is not first[0]]
    assert _inside(second, run) and not _inside(second, place)
    assert _inside(second, blocks[-1])
    assert tracing.span("casper.run") is tracing.span("casper.block")


def test_warm_run_lowers_nothing(cold, tmp_path):
    eng, grid = _engine(), _grid()
    eng.run(grid, iters=10)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(grid, iters=10)
    spans = _spans(prof, tmp_path)
    assert not _named(spans, "casper.lower")
    assert not _named(spans, "casper.verify")
    assert len(_named(spans, "casper.run")) == 1
    assert len(_named(spans, "casper.block")) == 3


def test_spans_follow_a_started_and_stopped_session():
    prof = profile(activities=[ProfilerActivity.CPU])
    off = tracing.span("casper.run")
    prof.start()
    try:
        on = tracing.span("casper.run")
        assert on is not off
        with on:
            pass
    finally:
        prof.stop()
    assert tracing.span("casper.run") is off


def test_set_up_timers_grow_on_a_miss_only(cold):
    eng, grid = _engine(), _grid()
    assert tplan.PLAN_CACHE.stats()["lower_s"] == 0
    assert analysis.counters()["seconds"] == 0
    eng.run(grid, iters=8)                      # one plan: a miss
    lower_s = tplan.PLAN_CACHE.stats()["lower_s"]
    verify_s = analysis.counters()["seconds"]
    assert lower_s > 0 and verify_s > 0
    eng.run(grid, iters=8)                      # a hit
    assert tplan.PLAN_CACHE.stats()["lower_s"] == lower_s
    assert analysis.counters()["seconds"] == verify_s
    # a report-cache hit runs no verification and adds nothing
    tplan.PLAN_CACHE.clear()
    eng.run(grid, iters=8)
    assert analysis.counters()["report_cache_hits"] >= 1
    assert analysis.counters()["seconds"] == verify_s
    assert tplan.PLAN_CACHE.stats()["lower_s"] > 0
    tplan.PLAN_CACHE.clear()
    analysis.clear_reports()
    assert tplan.PLAN_CACHE.stats()["lower_s"] == 0
    assert analysis.counters()["seconds"] == 0
