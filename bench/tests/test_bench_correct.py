"""A run is correct only when the timed path's answers equal the
reference's: a clean run passes; the control (the reference in float32
in the program's place) and each planted fault of the timed path fail.

The harness runs here on the CPU at small sizes, past its look for a
card, with the program's plain kernel versions in the kernels' place."""
import pytest
import torch

import _tiny
import control

CELLS = ["jacobi2d-f64.solve", "heat3d-f64.solve"]


@pytest.mark.parametrize("name", CELLS)
def test_a_clean_run_is_correct(name):
    line = _tiny.run(_tiny.cell(name))
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    from reference import compare
    checked, n = control.control_checks(_tiny.cell(name), 2 ** 31 + 9,
                                        torch.device("cpu"))
    assert n == 1
    assert not compare.passed(checked)
    assert checked["wrong"]["value"] == n
    assert checked["max_abs_err"]["value"] > 0


def _unchanged(self, grid, iters=1):
    return torch.as_tensor(grid).clone()


def _altered(run):
    def patched(self, grid, iters=1):
        out = run(self, grid, iters).clone()
        out.view(-1)[out.numel() // 3] += 1e-12
        return out
    return patched


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_faulty_solve_is_not_correct(monkeypatch, name, fault):
    from repro_torch.core.engine import CasperEngine
    patch = _unchanged if fault == "unchanged" else _altered(CasperEngine.run)
    monkeypatch.setattr(CasperEngine, "run", patch)
    line = _tiny.run(_tiny.cell(name))
    assert line["correct"] is False
    assert line["checks"]["wrong"]["value"] == line["attempted"]


def test_one_wrong_solve_among_many_is_caught(monkeypatch):
    """A solve that is neither the last nor the kept sample is judged by
    its fingerprint alone."""
    from repro_torch.core.engine import CasperEngine
    run, calls = CasperEngine.run, {"n": 0}

    def once(self, grid, iters=1):
        out = run(self, grid, iters)
        calls["n"] += 1
        if calls["n"] == 5:          # three warm-up calls, then solve 2
            out = out.clone()
            out.view(-1)[-1] += 1e-12
        return out

    monkeypatch.setattr(CasperEngine, "run", once)
    line = _tiny.run(_tiny.cell("jacobi2d-f64.solve"))
    assert line["attempted"] >= 3
    assert line["correct"] is False
    assert line["checks"]["wrong"]["value"] == 1
