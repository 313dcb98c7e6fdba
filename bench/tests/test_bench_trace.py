"""The trace reduction on hand-made events, and a traced run that stops
its trace before the window ends."""
import pytest

import _tiny
import devtrace
import harness


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev(devtrace.WINDOW, "user_annotation", 100, 1000),
    _ev("void casper_chain_kernel<double, 2>(double const*)", "kernel",
        50, 150),                                  # clipped to 100..200
    _ev("void casper_chain_kernel<double, 2>(double const*)", "kernel",
        180, 120),                                 # overlaps: 100..300
    _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 500, 100),
    _ev("other_kernel", "kernel", 1050, 200),      # clipped to 1050..1100
    _ev("aten::copy_", "cpu_op", 300, 150),
    _ev("cudaLaunchKernel", "cuda_runtime", 320, 10),
    _ev("bench.sync", "user_annotation", 600, 450),
]


def test_busy_is_the_clipped_union():
    tr = devtrace.Trace(EVENTS)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s() == pytest.approx((200 + 100 + 50) * 1e-6)


def test_kernel_time_by_prefix_is_unclipped():
    tr = devtrace.Trace(EVENTS)
    assert tr.kernel_s("casper_") == pytest.approx(270e-6)
    assert tr.kernel_s("other") == pytest.approx(200e-6)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    tr = devtrace.Trace(EVENTS)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(200e-6)     # 300..500
    assert gaps["bench.sync"] == pytest.approx(450e-6)      # 600..1050
    assert sum(gaps.values()) == pytest.approx(650e-6)
    ops = tr.device_ops()
    assert ops[0][0].startswith("void casper_chain_kernel")


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        devtrace.Trace(EVENTS[1:])


@pytest.mark.parametrize("name", ["jacobi2d-f64.solve", "heat3d-f64.solve"])
def test_a_trace_shorter_than_the_window(monkeypatch, name):
    monkeypatch.setattr(harness, "TRACE_S", 0.3)
    line = _tiny.run(_tiny.cell(name), seconds=1.0, trace=True)
    assert line["correct"] is True
    assert 0.25 < line["device"]["window_s"] < 0.8
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
