"""Each configuration states the program's stencil exactly."""
import copy

import pytest

import harness

CONFIGS = ["jacobi2d-f64", "heat3d-f64"]


def _config(name):
    return harness.read_json(harness.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_taps_are_the_programs(name):
    from repro_torch.core.stencil import PAPER_STENCILS
    cfg = _config(name)
    spec = harness.stencil_spec(cfg)
    assert spec.taps == PAPER_STENCILS[cfg["stencil"]].taps
    assert spec.boundary == cfg["boundary"] == "zero"
    assert cfg["dtype"] == "float64"
    assert cfg["engine"] == {"backend": "cuda", "sweeps": 4, "tile": None}
    assert cfg["reduced"] == ["levels"]
    assert cfg["levels"]["L3"] == cfg["source_levels"]["L3"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("fault", ["coefficient", "order", "boundary"])
def test_a_config_that_differs_is_refused(name, fault):
    cfg = copy.deepcopy(_config(name))
    if fault == "coefficient":
        cfg["taps"][1][1] = 0.25
    elif fault == "order":
        cfg["taps"][1], cfg["taps"][2] = cfg["taps"][2], cfg["taps"][1]
    else:
        cfg["boundary"] = "periodic"
        cfg["taps"] = cfg["taps"][:-1]
    with pytest.raises(ValueError):
        harness.stencil_spec(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_dram_level_is_four_times_the_l2(name):
    import math
    cfg = _config(name)
    assert math.prod(cfg["levels"]["DRAM"]) * 8 >= 4 * 50e6
