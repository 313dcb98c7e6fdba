"""The readers of the program's own spans and set-up timers, on hand-made
events and on a traced CPU run."""
import math

import pytest

import _tiny
import devtrace
import harness
import spans


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _ann(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


EVENTS = [
    _ann(devtrace.WINDOW, 100, 1000),
    _ann("casper.run", 40, 50),              # starts before the window
    _ann("casper.run", 120, 400),
    _ann("casper.block", 130, 100),
    _ann("casper.launch", 140, 20),
    _ann("casper.block", 240, 200),
    _ann("casper.launch", 250, 40),
    _ann("casper.run", 600, 300),
    _ann("casper.block", 610, 60),
    _ann("casper.launch", 620, 30),
    _ann("casper.run", 1150, 10),            # starts after the window
    _ann("casper.block", 1151, 5),
    _ann("casper.launch", 1152, 2),
]

#: reader -> its value on EVENTS: the mean over the spans that start
#: inside the window.
SPAN_READERS = {"run_host_ms": (400 + 300) / 2 / 1e3,
                "block_host_us": (100 + 200 + 60) / 3,
                "launch_host_us": (20 + 40 + 30) / 3}


def _plan():
    from repro_torch.core import plan
    return plan


def _analysis():
    from repro_torch import analysis
    return analysis


def _record(evs):
    return harness.Record(cell=None, counters={},
                          trace=devtrace.Trace(evs))


def test_within_keeps_the_spans_that_start_in_the_window():
    tr = devtrace.Trace(EVENTS)
    assert spans.within(tr, "casper.run") == [(120, 520), (600, 900)]
    assert len(spans.within(tr, "casper.launch")) == 3
    assert spans.within(tr, "casper.place") == []


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_takes_the_mean_inside_the_window(name):
    read = harness.metric_reader(name).read
    assert read(_record(EVENTS)) == pytest.approx(SPAN_READERS[name])


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_without_its_span_reads_none(name):
    read = harness.metric_reader(name).read
    outside = [e for e in EVENTS
               if not e["name"].startswith("casper.") or e["ts"] < 100
               or e["ts"] >= 1100]
    assert read(_record(outside)) is None
    assert read(harness.Record(cell=None, counters={})) is None


def test_an_idle_gap_inside_a_launch_is_named_by_the_launch():
    evs = [_ann(devtrace.WINDOW, 0, 1000),
           _ev("void casper_chain_kernel<double, 2>(double const*)",
               "kernel", 0, 400),
           _ev("void casper_chain_kernel<double, 2>(double const*)",
               "kernel", 600, 400),
           _ann("bench.solve", 300, 600),
           _ann("casper.run", 310, 580),
           _ann("casper.block", 420, 200),
           _ann("casper.launch", 430, 180),
           _ev("cudaLaunchKernel", "cuda_runtime", 590, 10)]
    gaps = dict(devtrace.Trace(evs).idle_gaps())
    assert gaps == {"casper.launch": pytest.approx(200e-6)}


@pytest.mark.parametrize("name,read_key", [
    ("lower_s", lambda: _plan().PLAN_CACHE.stats()["lower_s"]),
    ("verify_s", lambda: _analysis().counters()["seconds"]),
])
def test_a_counter_reader_reads_the_programs_total(name, read_key):
    _tiny.run(_tiny.cell("jacobi2d-f64.solve"), seconds=0.2)
    value = harness.metric_reader(name).read(_record(EVENTS))
    assert value == read_key() and value >= 0


@pytest.mark.parametrize("name", ["lower_s", "verify_s"])
def test_a_counter_reader_of_a_program_without_it_reads_none(
        monkeypatch, name):
    # the counters as a program without the timers has them
    if name == "lower_s":
        monkeypatch.setattr(_plan().PLAN_CACHE, "stats",
                            lambda: {"lowers": 1, "hits": 0})
    else:
        monkeypatch.setattr(_analysis(), "counters",
                            lambda: {"verifications": 1})
    assert harness.metric_reader(name).read(_record(EVENTS)) is None


@pytest.mark.parametrize("name", ["jacobi2d-f64.solve", "heat3d-f64.solve"])
def test_a_traced_run_reports_the_programs_spans(name):
    line = _tiny.run(_tiny.cell(name), seconds=0.5, trace=True)
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    for k in ("run_host_ms", "block_host_us", "lower_s", "verify_s"):
        assert math.isfinite(got[k]) and got[k] > 0, k
    # a block is part of a run
    assert got["block_host_us"] < 1e3 * got["run_host_ms"]
    # the CPU runs the kernels' plain versions and never launches
    assert "launch_host_us" not in got
