"""The benchmark's tests (``bench/tests``) share worker processes with the
JAX package's tests.  A run of the benchmark loads no module of JAX or
of the JAX package (``bench/harness.py`` refuses one that did), so while
a test of the benchmark runs, the modules other tests loaded are taken
out of ``sys.modules``; they are put back after it."""
import sys
from pathlib import Path

import pytest

BENCH_TESTS = Path(__file__).resolve().parent / "bench" / "tests"


@pytest.fixture(autouse=True)
def _a_benchmark_process(request, monkeypatch):
    if request.path.parent == BENCH_TESTS:
        import harness
        for name in harness.forbidden_loaded():
            monkeypatch.delitem(sys.modules, name)
    yield
