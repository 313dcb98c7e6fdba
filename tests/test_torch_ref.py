"""The torch oracle (``repro_torch.core.ref``) vs ``repro.core.ref``.

The same numpy inputs (``np.random.default_rng``) go through both; f64
results must be bitwise equal, f32 within ``atol=1e-5`` (the tolerance of
``tests/test_engine.py``).  f64 on the JAX side is scoped with
``jax.enable_x64(True)`` per test, never flipped globally.  The fused
window core (``masked_window_sweeps``) is held in ``test_torch_window.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import ref as jref
from repro_torch import spec_from_reference
from repro_torch.core import ref as tref

BOUNDARIES = ["zero", "constant(0.75)", "periodic", "reflect"]
GRIDS = {1: (41,), 2: (13, 22), 3: (7, 9, 12)}


def _pair(name, boundary, structure="auto"):
    ref = J_SPECS[name].with_boundary(boundary)
    if structure == "dense":
        ref = ref.with_structure("dense")
    return ref, spec_from_reference(ref)


def _check(got: torch.Tensor, want, dtype):
    want = np.asarray(want)
    assert got.dtype == (torch.float64 if dtype == np.float64
                         else torch.float32)
    assert got.shape == want.shape
    if dtype == np.float64:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_index_maps_match_reference(n):
    g = np.arange(-13, 17)
    np.testing.assert_array_equal(tref.periodic_index(torch.from_numpy(g), n)
                                  .numpy(), jref.periodic_index(g, n))
    np.testing.assert_array_equal(tref.reflect_index(torch.from_numpy(g), n)
                                  .numpy(), jref.reflect_index(g, n))
    for i in (-7, 0, n - 1, n + 3):
        assert tref.reflect_index(i, n) == int(jref.reflect_index(
            np.asarray(i), n))


@pytest.mark.parametrize("mode", ["zero", "constant", "periodic", "reflect"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_pad_boundary_deeper_than_grid(rank, mode):
    """Ghost depth past the grid's own size: F.pad cannot, the index
    gather must still equal jnp.pad's wrap/reflect."""
    rng = np.random.default_rng(rank)
    shape = {1: (3,), 2: (2, 3), 3: (1, 2, 3)}[rank]
    widths = {1: (7,), 2: (5, 8), 3: (3, 4, 9)}[rank]
    a = rng.standard_normal(shape)
    with jax.enable_x64(True):
        want = jref.pad_boundary(jnp.asarray(a), widths, mode, 0.75)
        got = tref.pad_boundary(torch.from_numpy(a), widths, mode, 0.75)
        _check(got, want, np.float64)


# forced "dense" differs from "auto" only for the separable specs (a
# star spec's auto path already is the dense tap chain)
STRUCTURE_CASES = [(n, "auto") for n in J_SPECS] + [
    ("blur2d", "dense"), ("star33_3d", "dense")]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name,structure", STRUCTURE_CASES)
def test_apply_stencil_matches_reference(name, structure, boundary, dtype):
    ref, port = _pair(name, boundary, structure)
    rng = np.random.default_rng(1)
    a = rng.standard_normal(GRIDS[ref.ndim]).astype(dtype)
    with jax.enable_x64(True):
        want = jax.jit(lambda x: jref.apply_stencil(ref, x))(jnp.asarray(a))
        _check(tref.apply_stencil(port, torch.from_numpy(a)), want, dtype)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", ["jacobi1d", "blur2d", "heat3d"])
def test_run_iterations_matches_reference(name, boundary):
    ref, port = _pair(name, boundary)
    rng = np.random.default_rng(2)
    a = rng.standard_normal(GRIDS[ref.ndim])
    with jax.enable_x64(True):
        want = jax.jit(lambda x: jref.run_iterations(ref, x, 5))(
            jnp.asarray(a))
        _check(tref.run_iterations(port, torch.from_numpy(a), 5), want,
               np.float64)
