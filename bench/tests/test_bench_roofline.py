"""The roofline's counts against hand values."""
import pytest

import roofline


def test_jacobi2d_solve_is_compute_bound():
    w = roofline.solve_work(5, (8192, 8192), 1000, "float64")
    assert w == {"flops": 10 * 8192 ** 2 * 1000, "bytes": 16 * 8192 ** 2}
    s, term = roofline.solve_bound_s(5, (8192, 8192), 1000, "float64")
    assert term == "compute"
    assert s == pytest.approx(671088640000 / 34e12)      # 19.74 ms


def test_heat3d_solve_is_compute_bound():
    s, term = roofline.solve_bound_s(7, (512, 512, 256), 1000, "float64")
    assert term == "compute"
    assert s == pytest.approx(14 * 512 * 512 * 256 * 1000 / 34e12)  # 27.6 ms


def test_one_iteration_is_memory_bound():
    s, term = roofline.solve_bound_s(5, (1024, 1024), 1, "float64")
    assert term == "memory"
    assert s == pytest.approx(16 * 1024 ** 2 / 3.35e12)


def test_the_peaks_are_the_h100s():
    assert roofline.CARD == "NVIDIA H100 80GB HBM3"
    assert roofline.PEAKS == {"float64": 34e12, "float32": 67e12,
                              "hbm_bytes_per_s": 3.35e12}
