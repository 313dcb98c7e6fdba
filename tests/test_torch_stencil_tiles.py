"""The pad-free stencil kernel's tile logic (K1/K3, ``csrc/stencil.cu``),
held against the reference through its CPU mirror
(``tests/_stencil_tile_mirror.py``):

* the rim-only, axis-by-axis restoration is bitwise equal to the
  whole-buffer ``_restore_ghosts`` of ``repro_torch.core.ref`` and of
  ``repro.core.ref`` on random f64 buffers;
* an interior tile's window lies inside the grid and a rim tile's
  leaves it, over rank 1-3, tiles and grids down to extent 1;
* a whole fused block built from the mirror (interior tiles copied
  without an index map and never restored) is bitwise equal to
  ``repro.core.ref`` (JAX, x64) and to the kernels' plain versions, for
  the paper stencils and pipelines and for random chains of 1-3 stages;
* the shared-memory layout (``plan.kernel_layout``) holds every
  intermediate, and the rule that picks the ``cp.async`` load path
  (``plan.load_path``) only picks it where every window starts on the
  layout's 16-byte lead.

Inputs come from ``np.random.default_rng``; JAX f64 is scoped with
``jax.enable_x64(True)``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _pipeline_cases import random_pipeline
from _stencil_tile_mirror import (fused_block, is_interior, restore_rim,
                                  tile_origins, window_coords)
from repro.core import PAPER_PIPELINES as J_PIPES
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import ref as jref
from repro_torch import spec_from_reference
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.kernels import engine as teng

MODES = ("zero", "constant", "periodic", "reflect")
BOUNDARIES = ("zero", "constant(0.75)", "periodic", "reflect")
EXAMPLES = 40


@settings(max_examples=EXAMPLES, deadline=None, derandomize=True)
@given(st.integers(1, 3), st.sampled_from(MODES), st.integers(0, 10 ** 6))
def test_rim_restoration_matches_restore_ghosts(ndim, mode, seed):
    rng = np.random.default_rng(seed)
    grid = tuple(int(n) for n in rng.integers(1, 8, size=ndim))
    cur = tuple(int(n) for n in rng.integers(1, 10, size=ndim))
    g0s = tuple(int(g) for g in rng.integers(-6, 7, size=ndim))
    acc = rng.standard_normal((2,) + cur)
    want = tref._restore_ghosts(torch.from_numpy(acc), mode, 0.75, g0s, grid,
                                cur)
    got = restore_rim(torch.from_numpy(acc), mode, 0.75, g0s, grid, cur)
    assert torch.equal(got, want)
    with jax.enable_x64(True):
        jwant = np.stack([np.asarray(jref._restore_ghosts(
            jnp.asarray(a), mode, 0.75, g0s, grid, cur)) for a in acc])
    np.testing.assert_array_equal(got.numpy(), jwant)


@settings(max_examples=EXAMPLES, deadline=None, derandomize=True)
@given(st.integers(1, 3), st.integers(1, 4), st.integers(0, 10 ** 6))
def test_interior_windows_inside_and_rim_windows_outside(ndim, sweeps, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(int(n) for n in rng.integers(1, 40, size=ndim))
    tile = tuple(int(t) for t in rng.integers(1, 12, size=ndim))
    halo = tuple(int(h) for h in rng.integers(0, 3, size=ndim))
    deep = tuple(sweeps * h for h in halo)
    for origin in tile_origins(shape, tile):
        inside = [all(0 <= g < n for g in r)
                  for r, n in zip(window_coords(origin, tile, deep), shape)]
        assert is_interior(origin, tile, deep, shape) == all(inside)


def _paper_cases():
    cases = []
    for name, spec in list(J_SPECS.items()) + list(J_PIPES.items()):
        for boundary in BOUNDARIES:
            cases.append((name, boundary))
    return cases


# grids and tiles with interior and rim tiles at sweeps 1 and 3 for every
# paper stencil and pipeline (radius up to 3 in 1-D, 2 in 2-D and 3-D)
_SHAPES = {1: ((60,), (12,)), 2: ((28, 30), (4, 6)), 3: ((18, 18, 19),
                                                        (2, 2, 3))}


@pytest.mark.parametrize("sweeps", (1, 3))
@pytest.mark.parametrize("name,boundary", _paper_cases())
def test_mirror_block_matches_reference(name, boundary, sweeps):
    ref = (J_SPECS.get(name) or J_PIPES[name]).with_boundary(boundary)
    port = spec_from_reference(ref)
    shape, tile = _SHAPES[port.ndim]
    a = np.random.default_rng(sweeps * 1000 + len(name)).standard_normal(shape)
    got, n_int, n_rim = fused_block(port, torch.from_numpy(a), tile, sweeps)
    assert n_int > 0 and n_rim > 0
    plain = teng.stencil_sweep_plain(port, torch.from_numpy(a), tile, sweeps)
    assert torch.equal(got, plain)
    with jax.enable_x64(True):
        run = jref.run_pipeline if hasattr(ref, "stages") \
            else jref.run_iterations
        want = np.asarray(run(ref, jnp.asarray(a), sweeps))
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=EXAMPLES, deadline=None, derandomize=True)
@given(st.integers(0, 10 ** 6), st.integers(1, 3), st.booleans(),
       st.integers(1, 3), st.integers(1, 4))
def test_mirror_block_matches_plain_on_random_chains(seed, ndim, periodic,
                                                     n_stages, sweeps):
    """Random fusable chains (the fuzz harness's generator), grids and
    tiles down to extent 1, grids below the halo included."""
    pipe = random_pipeline(seed, ndim, periodic, n_stages)
    rng = np.random.default_rng(seed + 1)
    shape = tuple(int(n) for n in rng.integers(1, 14, size=ndim))
    tile = tuple(int(t) for t in rng.integers(1, 6, size=ndim))
    a = torch.from_numpy(rng.standard_normal(shape))
    got, _, _ = fused_block(pipe, a, tile, sweeps)
    assert torch.equal(got, teng.pipeline_sweep_plain(pipe, a, tile, sweeps))
    if n_stages == 1:
        spec = pipe.stages[0]
        got, _, _ = fused_block(spec, a, tile, sweeps)
        assert torch.equal(got, teng.stencil_sweep_plain(spec, a, tile,
                                                         sweeps))


def _spans(layout, b, lo, hi, ndim):
    """Smallest and largest position in buffer ``b`` of the window box
    ``[lo, hi)`` (rank-3 carried coordinates)."""
    first = layout.offset(b, lo) + layout.base[b]
    last = layout.offset(b, [h - 1 for h in hi]) + layout.base[b]
    return first, last


@settings(max_examples=EXAMPLES, deadline=None, derandomize=True)
@given(st.integers(0, 10 ** 6), st.integers(1, 3), st.integers(1, 4),
       st.sampled_from((2, 4, 8)))
def test_kernel_layout_holds_every_intermediate(seed, ndim, sweeps,
                                                itemsize):
    pipe = random_pipeline(seed, ndim, False, 1 + seed % 3)
    rng = np.random.default_rng(seed)
    tile = tuple(int(t) for t in rng.integers(1, 40, size=ndim))
    ly = tplan.kernel_layout(tile, pipe, sweeps, itemsize)
    vec = 16 // itemsize if itemsize >= 4 else 1
    pad = 3 - ndim
    t3 = (1,) * pad + tile
    full = [0] * pad + [sweeps * h for h in pipe.halo]
    win = [t + 2 * f for t, f in zip(t3, full)]
    assert ly.row % vec == 0 and ly.row >= ly.lead + win[2]
    assert ly.lead == (-full[2]) % vec
    # the window in buffer 0, every intermediate in buffer 1
    lo, hi = _spans(ly, 0, [0, 0, 0], win, ndim)
    assert lo >= 0 and hi < ly.elems[0]
    rem = list(full)
    for _ in range(sweeps):
        for st_ in pipe.stages:
            rem = [r - h for r, h in zip(rem, [0] * pad + list(st_.halo))]
            c = [f - r for f, r in zip(full, rem)]
            if sweeps * pipe.n_stages > 1:
                lo, hi = _spans(ly, 1, c, [w - x for w, x in zip(win, c)],
                                ndim)
                assert lo >= 0 and hi < ly.elems[1]
    assert tplan.smem_bytes(tile, pipe, sweeps, itemsize) == \
        sum(ly.elems) * max(itemsize, 4)


@pytest.mark.parametrize("shape,tile,itemsize,ptr,path", [
    ((8192, 8192), (32, 128), 8, 0, "async"),
    ((8192, 8192), (32, 128), 4, 256, "async"),
    ((8192, 8192), (32, 128), 2, 0, "plain"),          # bf16: widened
    ((77, 301), (32, 128), 8, 0, "plain"),             # 2408-byte rows
    ((160, 512), (32, 128), 8, 8, "plain"),            # data not aligned
    ((64, 100), (16, 30), 4, 0, "plain"),              # tile row 120 bytes
    ((64, 100), (16, 32), 4, 0, "async"),              # 400-byte rows
    ((10007,), (4096,), 8, 0, "plain"),
    ((20480,), (4096,), 8, 0, "async"),
    ((24, 48, 96), (8, 16, 32), 8, 0, "async"),
    ((37, 45, 101), (8, 16, 32), 4, 0, "plain"),
])
def test_load_path_rule(shape, tile, itemsize, ptr, path):
    assert tplan.load_path(shape, tile, itemsize, ptr) == path


@settings(max_examples=EXAMPLES, deadline=None, derandomize=True)
@given(st.integers(1, 3), st.integers(1, 4), st.sampled_from((4, 8)),
       st.integers(0, 10 ** 6))
def test_async_windows_start_on_the_layout_lead(ndim, sweeps, itemsize,
                                                seed):
    """Where the rule picks ``cp.async``, every tile's window starts at a
    column congruent to the layout's lead modulo 16 bytes, and the
    16-byte chunks covering a window row stay inside the grid row for
    interior tiles and inside the buffer row."""
    rng = np.random.default_rng(seed)
    vec = 16 // itemsize
    shape = tuple(int(n) for n in rng.integers(1, 5, size=ndim) * vec)
    tile = tuple(int(t) for t in rng.integers(1, 4, size=ndim) * vec)
    spec = random_pipeline(seed, ndim, False, 1).stages[0]
    assert tplan.load_path(shape, tile, itemsize) == "async"
    ly = tplan.kernel_layout(tile, spec, sweeps, itemsize)
    full = sweeps * spec.halo[-1]
    win = tile[-1] + 2 * full
    chunks = -(-(ly.lead + win) // vec)
    assert chunks * vec <= ly.row
    deep = tuple(sweeps * h for h in spec.halo)
    for origin in tile_origins(shape, tile):
        start = origin[-1] - full
        assert (start - ly.lead) % vec == 0
        if is_interior(origin, tile, deep, shape):
            assert start - ly.lead >= 0
            assert start - ly.lead + chunks * vec <= shape[-1]


def test_smem_bytes_of_the_default_tiles():
    """Every paper stencil and pipeline has a default tile that fits,
    and two CTAs of K1/K3 fit one SM at the 2-D default tile (f64,
    sweeps=4)."""
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS
    for spec in list(PAPER_STENCILS.values()) + list(PAPER_PIPELINES.values()):
        tile = tplan.default_tile(spec, 4, 8)
        need = tplan.smem_bytes(tile, spec, 4, 8)
        assert need <= tplan._pm.H100_SMEM_PER_BLOCK
        if spec.ndim == 2:
            assert tile == (64, 64)
            assert 2 * (need + 1024) <= 233472          # 228 KB per SM
    assert math.prod(tplan.default_tile(PAPER_STENCILS["star33_3d"], 4, 8)) \
        == 256


def test_unit_stars_are_the_paper_radius_one_stars():
    """The kernel runs a stage in row strips only when its taps are the
    radius-1 star of rank 2 or 3 in the paper stencils' order, whose
    sum order the strip code spells out tap by tap."""
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS
    stars = {n: teng._is_unit_star(s) for n, s in PAPER_STENCILS.items()}
    assert stars == {"jacobi1d": False, "7pt1d": False, "jacobi2d": True,
                     "blur2d": False, "heat3d": True, "star33_3d": False}
    for pipe in PAPER_PIPELINES.values():
        for st_ in pipe.stages:
            assert teng._is_unit_star(st_) == (st_.name != "advect2d")
    j2 = PAPER_STENCILS["jacobi2d"]
    swapped = type(j2)("swapped", 2, (j2.taps[0], j2.taps[2], j2.taps[1])
                       + j2.taps[3:])
    assert not teng._is_unit_star(swapped)
