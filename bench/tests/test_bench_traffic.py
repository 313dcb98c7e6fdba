"""Seeded inputs repeat exactly and differ by seed."""
import pytest
import torch

import _tiny
import harness


@pytest.mark.parametrize("name", ["jacobi2d-f64.solve", "heat3d-f64.solve"])
def test_inputs_repeat_and_differ_by_seed(name):
    cell = _tiny.cell(name)
    spec = harness.stencil_spec(cell.config)

    def make(seed):
        ctx = harness.Context(cell, spec, seed, 1.0, torch.device("cpu"))
        return cell.traffic.inputs(ctx)

    a, b, c = make(2 ** 31 + 1), make(2 ** 31 + 1), make(2 ** 31 + 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tuple(a.shape) == tuple(cell.config["levels"]["DRAM"])


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, 2 ** 31 + 17,
                                  987654321987])
def test_a_large_seed_runs(seed):
    line = _tiny.run(_tiny.cell("jacobi2d-f64.solve"), seed=seed,
                     seconds=0.2)
    assert line["correct"] is True and line["attempted"] >= 1
