"""Nothing a run loads is JAX or the JAX package (top-level names
compared whole), and a machine without the card gets no result."""
import json
import subprocess
import sys

import pytest

import harness

PROBE = r"""
import json, sys
sys.path[:0] = [{src!r}, {bench!r}, {tests!r}]
import _tiny, harness
for name in ("jacobi2d-f64.solve", "heat3d-f64.solve"):
    line = _tiny.run(_tiny.cell(name), trace=True)
    assert line["correct"], line
import control, spread  # every module of the harness
print(json.dumps(harness.forbidden_loaded()))
"""


def test_a_run_loads_no_jax_module():
    code = PROBE.format(src=str(harness.ROOT / "src"),
                        bench=str(harness.BENCH),
                        tests=str(harness.BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_loaded() == ["jax", "repro.core"]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "jacobi2d-f64.solve", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "jacobi2d-f64.solve", "--seed", "7", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
