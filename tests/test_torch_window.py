"""The fused window core: torch ``masked_window_sweeps`` vs
``repro.core.ref.masked_window_sweeps``.

The shared core of kernels K1 and K2, over rank 1-3 x 4 boundaries x
structure (auto/dense) x sweeps {1,2,3}: f64 bitwise equal, f32 within
``atol=1e-5``.  Kept apart from ``test_torch_ref.py`` so the two files
run on separate test workers.
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
# one spec per rank; blur2d and star33_3d are separable, so their auto
# structure differs from forced dense
RANK_SPECS = {1: "7pt1d", 2: "blur2d", 3: "star33_3d"}
GRIDS = {1: (41,), 2: (13, 22), 3: (7, 9, 12)}


def _pair(name, boundary, structure):
    ref = J_SPECS[name].with_boundary(boundary)
    if structure == "dense":
        ref = ref.with_structure("dense")
    return ref, spec_from_reference(ref)


def _check(got: torch.Tensor, want, dtype):
    want = np.asarray(want)
    assert got.shape == want.shape
    if dtype == np.float64:
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _windows(port, a, out_shape, sweeps, starts_list):
    """Windows of ``a``'s boundary extension at each tile origin."""
    wide = tuple(sweeps * h for h in port.halo)
    padded = tref.pad_boundary(torch.from_numpy(a), wide, port.boundary_mode,
                               port.boundary_value)
    return torch.stack([padded[tuple(slice(s, s + t + 2 * w)
                                     for s, t, w in zip(st, out_shape, wide))]
                        for st in starts_list])


def _masked_sweeps_case(rank, boundary, structure, sweeps, dtype):
    """The fused core on a leading batch of windows at per-window origins
    (left edge, interior, right edge): one batched call on the torch
    side, the JAX core vmapped over the same windows and origins (its
    ``starts`` are traced there, as inside the Pallas kernel)."""
    ref, port = _pair(RANK_SPECS[rank], boundary, structure)
    rng = np.random.default_rng(3)
    grid = GRIDS[rank]
    out_shape = {1: (8,), 2: (4, 8), 3: (2, 4, 4)}[rank]
    a = rng.standard_normal(grid).astype(dtype)
    starts_list = [(0,) * rank,
                   tuple(n // 3 for n in grid),
                   tuple(n - t for n, t in zip(grid, out_shape))]
    wins = _windows(port, a, out_shape, sweeps, starts_list)
    starts = tuple(torch.tensor([st[d] for st in starts_list])
                   for d in range(rank))
    acc = torch.float64 if dtype == np.float64 else torch.float32
    got = tref.masked_window_sweeps(
        wins, port.taps, port.halo, out_shape, sweeps, starts, grid, acc,
        mode=port.boundary_mode, value=port.boundary_value,
        structure=port.structure)

    def one(win, st):
        return jref.masked_window_sweeps(
            win, ref.taps, ref.halo, out_shape, sweeps,
            tuple(st[d] for d in range(rank)), grid, jnp.dtype(dtype),
            mode=ref.boundary_mode, value=ref.boundary_value,
            structure=ref.structure)

    with jax.enable_x64(True):
        want = jax.jit(jax.vmap(one))(
            jnp.asarray(wins.numpy()),
            jnp.asarray(np.array(starts_list), jnp.int32))
        _check(got, want, dtype)


# forced "dense" differs from "auto" only for the separable rank-2/3 specs
RANK_STRUCTURES = [(1, "auto"), (2, "auto"), (2, "dense"), (3, "auto"),
                   (3, "dense")]


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("rank,structure", RANK_STRUCTURES)
def test_masked_window_sweeps_f64_bitwise(rank, structure, boundary, sweeps):
    _masked_sweeps_case(rank, boundary, structure, sweeps, np.float64)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("rank,structure", RANK_STRUCTURES)
def test_masked_window_sweeps_f32_tolerance(rank, structure, boundary):
    _masked_sweeps_case(rank, boundary, structure, 2, np.float32)
