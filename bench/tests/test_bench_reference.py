"""The plain reference equals the port's oracle (``backend="ref"``) bit
for bit in float64, and the comparison's fingerprint is exact."""
import pytest
import torch

import harness
from reference import compare
from reference import stencil as reference

CASES = [("jacobi2d-f64", (33, 47)), ("heat3d-f64", (9, 14, 11))]


@pytest.mark.parametrize("name,shape", CASES)
@pytest.mark.parametrize("boundary", ["zero", "periodic", "reflect",
                                      "constant(0.5)"])
def test_reference_equals_the_ports_oracle(name, shape, boundary):
    from repro_torch import CasperEngine
    cfg = harness.read_json(harness.BENCH / "configs" / f"{name}.json")
    spec = harness.stencil_spec(cfg).with_boundary(boundary)
    g = torch.Generator().manual_seed(3)
    x = torch.rand(shape, generator=g, dtype=torch.float64)
    want = CasperEngine(spec, backend="ref", device="cpu").run(x, 9)
    got = reference.run(x, cfg["taps"], boundary, 9)
    assert torch.equal(got, want)
    batch = torch.stack([x, x.flip(0)])
    assert torch.equal(reference.run(batch, cfg["taps"], boundary, 9)[0],
                       want)


@pytest.mark.parametrize("name,shape", CASES)
def test_reference_equals_the_ports_kernel_path(name, shape):
    from repro_torch import CasperEngine
    cfg = harness.read_json(harness.BENCH / "configs" / f"{name}.json")
    spec = harness.stencil_spec(cfg)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64)
    eng = CasperEngine(spec, device="cpu", **cfg["engine"])
    assert torch.equal(eng.run(x, 13), reference.run(x, cfg["taps"],
                                                     "zero", 13))


def test_snapshots_are_the_states_after_each_count():
    taps = [[[0], 0.5], [[-1], 0.25], [[1], 0.25]]
    x = torch.rand(20, dtype=torch.float64)
    snaps = reference.run(x, taps, "zero", 6, snapshots=(2, 6))
    assert torch.equal(snaps[2], reference.run(x, taps, "zero", 2))
    assert torch.equal(snaps[6], reference.run(x, taps, "zero", 6))


def test_fingerprint_sees_one_changed_bit():
    x = torch.rand(64, 64, dtype=torch.float64)
    y = x.clone()
    y.view(torch.int64)[5, 7] ^= 1
    assert int(compare.fingerprint(x)) == int(compare.fingerprint(x.clone()))
    assert int(compare.fingerprint(x)) != int(compare.fingerprint(y))


def test_checks_hold_each_number_to_its_limit():
    assert compare.passed(compare.checks(0, 0, 0.0))
    for bad in [(1, 0, 0.0), (0, 1, 0.0), (0, 0, 1e-17),
                (0, 0, float("inf"))]:
        assert not compare.passed(compare.checks(*bad))
    nan = torch.tensor([float("nan")], dtype=torch.float64)
    assert compare.max_abs_err(nan, torch.zeros(1, dtype=torch.float64)) \
        == float("inf")
