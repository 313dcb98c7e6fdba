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
  layout's 16-byte lead;
* the streamed rank-3 order of K1/K2 (``stream_block`` in the mirror:
  rings of planes per application, lead-in planes of each z chunk,
  out-of-grid planes filled, formed or read from their mirror, rim
  restoration within a plane) is bitwise equal to the plain versions and
  to ``repro.core.ref``, for both entries, every boundary, sweeps 1/2/4,
  ragged xy tiles and z chunks, a shard's window and a batch; its layout
  (``plan.stream_layout``) fits one block at the default tiles, which
  ``plan.default_tile`` picks the same way every time;
* the launch geometry (``plan.launch_blocks``) puts a batch of 70,000
  grids on one launch, and the default periodic budget sends every
  periodic grid the device holds to K1;
* small grids on the window kernel: the default tile fitted to an
  output smaller than it (``plan.normalize_tile``), the grids packed per
  CTA (``plan.pack_factor``), the shared memory of a packed CTA and the
  padded windows' lead, the padded entry's ``cp.async`` rule, the
  small-grid strategy as measured, and the points the window kernel's
  CTAs form per output on the serving shapes (``window_kernel_block`` in
  the mirror) against a fitted tile's.

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
from _pipeline_cases import random_pipeline, separable_3d_specs
from _stencil_tile_mirror import (fused_block, is_interior, restore_rim,
                                  stream_block, stream_offset_table,
                                  stream_ring_depths, tabled_apply,
                                  tile_origins, window_coords)
from repro.core import PAPER_PIPELINES as J_PIPES
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import ref as jref
from repro_torch import spec_from_reference
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.core.stencil import as_stages
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
    two CTAs of K1/K3 fit one SM at the 2-D default tile (f64,
    sweeps=4), and the rank-3 specs stream 32-plane chunks of the widest
    xy tile whose rings fit."""
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS
    for spec in list(PAPER_STENCILS.values()) + list(PAPER_PIPELINES.values()):
        tile = tplan.default_tile(spec, 4, 8)
        need = tplan.smem_bytes(tile, spec, 4, 8)
        assert need <= tplan._pm.H100_SMEM_PER_BLOCK
        if spec.ndim == 2:
            assert tile == (64, 64)
            assert 2 * (need + 1024) <= 233472          # 228 KB per SM
    assert tplan.default_tile(PAPER_STENCILS["star33_3d"], 4, 8) \
        == (32, 16, 16)
    assert tplan.default_tile(PAPER_STENCILS["heat3d"], 4, 8) == (32, 32, 32)


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


# ---------------------------------------------------------------------------
# Rank 3 streamed along dim 0 (K1/K2 of a 3-D spec)
# ---------------------------------------------------------------------------
# (shape, tile): ragged xy tiles and z chunks with interior and rim tiles
# at sweeps 1, a chunk deeper than the grid, and a grid below the window
_STREAM_SHAPES = (((23, 21, 26), (7, 6, 8)), ((9, 11, 10), (16, 4, 8)),
                  ((3, 5, 6), (2, 8, 4)))


def _stream_specs():
    return [(n, b) for n in ("heat3d", "star33_3d") for b in BOUNDARIES]


@pytest.mark.parametrize("sweeps", (1, 2, 4))
@pytest.mark.parametrize("name,boundary", _stream_specs())
def test_stream_mirror_matches_plain_and_reference(name, boundary, sweeps):
    """K1's streamed order, bitwise against the plain version (its own
    3-D tiles) and the JAX oracle; K2's on the same grid's padded window
    against its plain version."""
    ref = J_SPECS[name].with_boundary(boundary)
    port = spec_from_reference(ref)
    for k, (shape, tile) in enumerate(_STREAM_SHAPES):
        a = np.random.default_rng(100 * sweeps + k).standard_normal(shape)
        x = torch.from_numpy(a)
        got, n_int, n_rim = stream_block(port, x, tile, sweeps)
        assert n_rim > 0 and (n_int > 0 or k or sweeps > 1)
        assert torch.equal(got, teng.stencil_sweep_plain(port, x, tile,
                                                         sweeps))
        with jax.enable_x64(True):
            want = np.asarray(jref.run_iterations(ref, jnp.asarray(a),
                                                  sweeps))
        np.testing.assert_array_equal(got.numpy(), want)
        wide = tuple(sweeps * h for h in port.halo)
        win = tref.pad_boundary(x, wide, port.boundary_mode,
                                port.boundary_value)
        got2, _, _ = stream_block(port, win, tile, sweeps, origin=(0, 0, 0),
                                  grid_shape=shape, out_shape=shape)
        assert torch.equal(got2, teng.stencil_window_sweep_plain(
            port, win, shape, (0, 0, 0), shape, tile, sweeps))


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_stream_mirror_on_separable_specs(boundary):
    """The streamed order on rank-3 separable specs other than
    star33_3d (terms of three factors, of two without dim 0, of one),
    bitwise against the plain version and ``repro.core.ref``, on both
    entries."""
    from repro.core.stencil import StencilSpec as JSpec
    sweeps, shape, tile = 2, (11, 13, 12), (4, 8, 8)
    for k, port in enumerate(separable_3d_specs(boundary)):
        ref = JSpec(port.name, 3, port.taps, boundary=boundary,
                    structure="separable")
        a = np.random.default_rng(40 + k).standard_normal(shape)
        x = torch.from_numpy(a)
        got, _, _ = stream_block(port, x, tile, sweeps)
        assert torch.equal(got, teng.stencil_sweep_plain(port, x, tile,
                                                         sweeps))
        with jax.enable_x64(True):
            want = np.asarray(jref.run_iterations(ref, jnp.asarray(a),
                                                  sweeps))
        np.testing.assert_array_equal(got.numpy(), want)
        wide = tuple(sweeps * h for h in port.halo)
        win = tref.pad_boundary(x, wide, port.boundary_mode,
                                port.boundary_value)
        got2, _, _ = stream_block(port, win, tile, sweeps, origin=(0, 0, 0),
                                  grid_shape=shape, out_shape=shape)
        np.testing.assert_array_equal(got2.numpy(), want)


def _table_specs():
    from repro_torch import PAPER_STENCILS
    star = PAPER_STENCILS["star33_3d"]
    return {"heat3d": PAPER_STENCILS["heat3d"], "star33_3d": star,
            "star33_3d-dense": star.with_structure("dense"),
            **{s.name: s for s in separable_3d_specs()}}


@pytest.mark.parametrize("name", list(_table_specs()))
def test_stream_offset_tables_read_the_right_planes(name):
    """The streamed kernel's general evaluator reads each tap through an
    offset table (ring slot of its plane plus its in-plane offset) and
    adds a term's factor offsets one inside the other, so only the
    innermost factor's carry the slot: evaluated that way on planes at
    scattered ring slots (other slots hold other data), every point
    equals one application of the spec on the stacked planes, bitwise."""
    spec = _table_specs()[name]
    h = spec.halo
    rng = np.random.default_rng(len(name))
    lead, cy, cx = 1, 7, 9
    ny, nx = cy + 2 * h[1], cx + 2 * h[2]
    row = lead + nx + 3
    depth = 2 * h[0] + 3
    order = rng.permutation(depth)
    slots = {dz: int(order[dz + h[0]]) * ny * row
             for dz in range(-h[0], h[0] + 1)}
    flat = torch.from_numpy(rng.standard_normal(depth * ny * row))
    x = torch.stack([flat[slots[dz]:slots[dz] + ny * row].reshape(ny, row)
                     [:, lead:lead + nx] for dz in range(-h[0], h[0] + 1)])
    terms = (None if spec.structure == "dense"
             else spec.factorization.compute_terms)
    want = tref._window_apply(x, spec.taps, h, (1, cy, cx), torch.float64,
                              terms)[0]
    q1, q2 = torch.meshgrid(torch.arange(cy), torch.arange(cx),
                            indexing="ij")
    at = lead + (q1 + h[1]) * row + (q2 + h[2])
    table = stream_offset_table(spec, slots.__getitem__, row)
    assert torch.equal(tabled_apply(spec, flat, at, table), want)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_stream_mirror_on_a_shard_window(boundary):
    """K2 on a shard: the window of a block of a larger grid, its ghosts
    neighbouring data inside the grid and boundary ghosts outside."""
    spec = spec_from_reference(J_SPECS["star33_3d"].with_boundary(boundary))
    sweeps, shape = 2, (14, 12, 13)
    a = torch.from_numpy(np.random.default_rng(7).standard_normal(shape))
    wide = tuple(sweeps * h for h in spec.halo)
    full = tref.pad_boundary(a, wide, spec.boundary_mode, spec.boundary_value)
    origin, out = (5, 0, 4), (7, 12, 9)
    win = full[tuple(slice(o, o + n + 2 * w)
                     for o, n, w in zip(origin, out, wide))]
    got, _, _ = stream_block(spec, win, (4, 8, 4), sweeps, origin=origin,
                             grid_shape=shape, out_shape=out)
    want = teng.stencil_window_sweep_plain(spec, win, out, origin, shape,
                                           (4, 8, 4), sweeps)
    assert torch.equal(got, want)
    whole = tref.run_iterations(spec, a, sweeps)
    assert torch.equal(got, whole[tuple(slice(o, o + n)
                                        for o, n in zip(origin, out))])


def test_stream_mirror_on_a_batch():
    """A batch: each grid streamed on its own equals the plain version of
    the batched launch."""
    spec = spec_from_reference(J_SPECS["heat3d"].with_boundary("reflect"))
    a = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 10, 9, 12)))
    want = teng.stencil_sweep_plain(spec, a, (4, 4, 8), 3)
    got = torch.stack([stream_block(spec, g, (4, 4, 8), 3)[0] for g in a])
    assert torch.equal(got, want)


@pytest.mark.parametrize("itemsize", (2, 4, 8))
@pytest.mark.parametrize("sweeps", (1, 2, 3, 4))
def test_stream_layout_fits_and_default_tile_is_stable(itemsize, sweeps):
    """The rings and tables of the streamed kernel fit one block's
    232,448 bytes at the default tile of every rank-3 paper stencil (the
    forced-dense star33_3d too), levels follow each other without
    overlap, and the default tile is the same on every call."""
    from repro_torch import PAPER_STENCILS
    specs = [PAPER_STENCILS["heat3d"], PAPER_STENCILS["star33_3d"],
             PAPER_STENCILS["star33_3d"].with_structure("dense")]
    for spec in specs:
        tile = tplan.default_tile(spec, sweeps, itemsize)
        assert tile == tplan.default_tile(spec, sweeps, itemsize)
        assert tile[0] == 32 and tile in tplan.HOPPER_TILES[3]
        ly = tplan.stream_layout(tile, spec, sweeps, itemsize)
        assert tplan.smem_bytes(tile, spec, sweeps, itemsize) == ly.smem
        assert ly.smem <= tplan._pm.H100_SMEM_PER_BLOCK
        assert (ly.depth0, ly.depth) == stream_ring_depths(spec)
        h = spec.halo
        assert ly.row >= ly.lead + tile[2] + 2 * sweeps * h[2]
        for lvl, plane in enumerate(ly.planes):
            assert plane == (tile[1] + 2 * (sweeps - lvl) * h[1]) * ly.row
        ends = [o + (ly.depth0 if lvl == 0 else ly.depth) * p
                for lvl, (o, p) in enumerate(zip(ly.level_off, ly.planes))]
        assert list(ly.level_off[1:]) == ends[:-1]
        assert ly.table_bytes >= ends[-1] * max(itemsize, 4)


@pytest.mark.parametrize("name,shape,sweeps,chunk,strategy", [
    ("heat3d", (32, 512, 512), 4, 24, "pad-free"),
    ("star33_3d", (37, 45, 101), 4, 21, "pad-free"),
    ("star33_3d", (256, 256, 64), 4, 32, "pad-free"),
    ("heat3d", (9, 40, 40), 4, 1, "pad-free"),
    ("heat3d", (8, 40, 40), 4, 8, "padded-window"),
])
def test_default_chunk_fits_a_shallow_grid(name, shape, sweeps, chunk,
                                           strategy):
    """On a grid shallower than a 32-plane chunk's window, the default
    tile's chunk is cut to the depth less ``2*sweeps*halo[0]``, so the
    window stays inside the grid and the plan stays pad-free (K1); a grid
    with no plane to spare takes the padded window, its chunk fitted to
    the grid's depth.  The plan, the strategy rule and the wrapper agree
    on the tile."""
    from repro_torch import PAPER_STENCILS
    spec = PAPER_STENCILS[name].with_boundary("reflect")
    tile = tplan.normalize_tile(spec, None, sweeps, 8, shape)
    assert tile == (chunk,) + tplan.default_tile(spec, sweeps, 8)[1:]
    assert tplan.ghost_strategy_for(spec, shape, 8, sweeps, None) == strategy
    plan = tplan.lower(spec, shape, torch.float64, backend="cuda",
                       sweeps=sweeps, device="cpu")
    assert plan.tile == tile and plan.ghost_strategy == strategy


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_stream_mirror_on_a_shallow_grid(boundary):
    """A grid shallower than the default chunk's window runs K1 on the cut
    chunk: the mirror's streamed order there equals the plain version and
    ``repro.core.ref``, as does the engine's run on the CPU."""
    from repro_torch import CasperEngine
    ref = J_SPECS["star33_3d"].with_boundary(boundary)
    spec = spec_from_reference(ref)
    sweeps, shape = 2, (13, 40, 36)
    tile = tplan.normalize_tile(spec, None, sweeps, 8, shape)
    assert tile[0] == 13 - 2 * sweeps * 2
    a = np.random.default_rng(13).standard_normal(shape)
    x = torch.from_numpy(a)
    got, _, _ = stream_block(spec, x, tile, sweeps)
    assert torch.equal(got, teng.stencil_sweep_plain(spec, x, tile, sweeps))
    with jax.enable_x64(True):
        want = np.asarray(jref.run_iterations(ref, jnp.asarray(a), sweeps))
    np.testing.assert_array_equal(got.numpy(), want)
    run = CasperEngine(spec, backend="cuda", sweeps=sweeps,
                       device="cpu").run(x, iters=sweeps)
    np.testing.assert_array_equal(run.numpy(), want)


def test_core27_flags_only_star33_structure():
    """The streamed kernel holds star33_3d's factored stage in registers
    only for its exact structure; the dense form and other stencils go
    by their taps."""
    from repro_torch import PAPER_STENCILS
    from repro_torch.core.stencil import _classify

    def flag(spec):
        terms = (None if spec.structure == "dense"
                 else _classify(3, spec.taps).compute_terms)
        return teng._is_core27(3, terms)
    star = PAPER_STENCILS["star33_3d"]
    assert flag(star)
    assert not flag(star.with_structure("dense"))
    assert not flag(PAPER_STENCILS["heat3d"])
    args = teng._args(star, False, 4, 1, (64, 64, 64), (32, 16, 32),
                      (64, 64, 64), (64, 64, 64), (0, 0, 0), 8, False)
    assert args.stream == 1 and args.stage[0].star == teng._CORE27
    assert args.n_foff == 15


def test_launch_blocks_folds_the_batch_into_one_axis():
    """70,000 grids of 8x8 are 70,000 CTAs of one launch (the batch no
    longer rides on gridDim.y, whose limit is 65,535); past 2**31 - 1
    CTAs the launch is refused before it reaches the card."""
    assert tplan.launch_blocks((8, 8), (64, 64), 70000) == 70000
    assert tplan.launch_blocks((37, 45, 101), (32, 16, 32), 3) == \
        3 * 2 * 3 * 4
    with pytest.raises(ValueError, match="CTAs"):
        tplan.launch_blocks((2 ** 20, 2 ** 20), (1, 32), 1)


def test_default_periodic_budget_sends_periodic_grids_to_k1():
    """With the default budget, a periodic grid the device holds runs
    pad-free (K1: no host pad), where a budget of a quarter of L2 sent
    jacobi2d 2048^2 f64 to K2; the rule is unchanged, so a budget passed
    in still decides."""
    from repro_torch import PAPER_STENCILS
    per = PAPER_STENCILS["jacobi2d"].with_boundary("periodic")
    assert tplan._pm.PERIODIC_WHOLE_GRID_BYTES == tplan._pm.H100_HBM_BYTES
    for shape in ((2048, 2048), (8192, 8192)):
        assert tplan.ghost_strategy_for(per, shape, 8, 4, None) == "pad-free"
    assert tplan.ghost_strategy_for(per, (2048, 2048), 8, 4, None,
                                    periodic_budget_bytes=0) \
        == "padded-window"
    plan = tplan.lower(per, (2048, 2048), torch.float64, backend="cuda",
                       sweeps=4, device="cpu")
    assert plan.ghost_strategy == "pad-free"


# ---------------------------------------------------------------------------
# Small grids on the window kernel: fitted tiles, several grids per CTA,
# padded windows copied by cp.async
# ---------------------------------------------------------------------------
_DTYPES = {8: torch.float64, 4: torch.float32, 2: torch.bfloat16}


def _serving_spec(name):
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS
    if name == "advect2d":
        return PAPER_PIPELINES["advect_diffuse2d"].stages[0]
    return PAPER_STENCILS.get(name) or PAPER_PIPELINES[name]


@pytest.mark.parametrize("name,shape,itemsize,tile", [
    ("jacobi2d", (8, 8), 8, (8, 8)),
    ("jacobi2d", (8, 8), 4, (8, 8)),
    ("jacobi2d", (32, 64), 8, (32, 64)),
    ("jacobi2d", (3, 7), 8, (3, 8)),        # the row to a 16-byte chunk
    ("jacobi2d", (3, 7), 4, (3, 8)),
    ("jacobi2d", (3, 7), 2, (3, 7)),        # bf16: a chunk of one
    ("jacobi2d", (40, 500), 8, (40, 64)),   # one dim cut
    ("jacobi2d", (77, 301), 8, (64, 64)),   # none
    ("jacobi1d", (512,), 8, (512,)),
    ("jacobi1d", (5,), 4, (8,)),
    ("jacobi1d", (10007,), 8, (4096,)),
    ("reaction_diffusion2d", (32, 64), 8, (32, 64)),
    ("heat3d", (8, 12, 16), 8, (8, 12, 16)),
    ("heat3d", (8, 12, 15), 4, (8, 12, 16)),
])
def test_default_tile_is_fitted_to_a_small_output(name, shape, itemsize,
                                                  tile):
    """A dim of the output shorter than the default tile's cuts the tile
    to it, the row rounded up to a whole 16-byte chunk; the plan, the
    strategy rule and the wrapper take the same tile, and an explicit
    tile is taken as it is."""
    spec = _serving_spec(name)
    assert tplan.normalize_tile(spec, None, 4, itemsize, shape) == tile
    plan = tplan.lower(spec, shape, _DTYPES[itemsize], backend="cuda",
                       sweeps=4, device="cpu")
    assert plan.tile == tile
    explicit = (2,) * spec.ndim
    assert tplan.normalize_tile(spec, explicit, 4, itemsize, shape) \
        == explicit


@pytest.mark.parametrize("name,shape,itemsize,batches,packs", [
    # (batch of 70,000, 4,096, 48, 3, 1) -> grids per CTA
    ("jacobi2d", (8, 8), 8, (70000, 4096, 48, 3, 1), (30, 16, 4, 3, 1)),
    ("jacobi2d", (8, 8), 4, (70000, 4096, 48, 3, 1), (54, 16, 4, 3, 1)),
    ("jacobi2d", (32, 64), 8, (70000, 4096, 48, 3, 1), (2, 2, 1, 1, 1)),
    ("jacobi2d", (32, 64), 4, (70000, 4096, 48, 3, 1), (5, 4, 1, 1, 1)),
    ("jacobi1d", (512,), 8, (70000, 4096, 48, 3, 1), (13, 8, 1, 1, 1)),
    ("jacobi1d", (512,), 4, (70000, 4096, 48, 3, 1), (27, 16, 1, 1, 1)),
    ("reaction_diffusion2d", (32, 64), 8, (70000, 4096), (1, 1)),
    ("reaction_diffusion2d", (32, 64), 4, (70000, 4096), (3, 3)),
    ("heat3d", (8, 12, 16), 8, (70000, 4096), (1, 1)),      # streamed
    ("jacobi2d", (64, 72), 8, (70000, 4096), (1, 1)),       # two tiles
])
def test_pack_factor_rule(name, shape, itemsize, batches, packs):
    """Grids per CTA: only a rank-1/2 grid that one tile covers packs, at
    most as many as keep two CTAs' buffers in an SM's shared memory; at
    that cap the batch takes W waves of the card's 264 resident CTAs
    (132 SMs x 2), and a CTA carries the fewest grids that still finish
    in W waves (jacobi1d (512,) x 4096 in f64: 8 per CTA, 512 CTAs in
    two full waves, not 13 and a second wave of 52), but at least as
    many as give each of the 256 threads a point of the last application
    and never more than the batch."""
    spec = _serving_spec(name)
    tile = tplan.normalize_tile(spec, None, 4, itemsize, shape)
    per = tplan.smem_bytes(tile, spec, 4, itemsize, padded=True)
    budget = (tplan._pm.H100_SMEM_PER_SM // tplan.CTAS_PER_SM
              - tplan._pm.H100_SMEM_RESERVED_PER_BLOCK)
    wave = tplan._pm.H100_SMS * tplan.CTAS_PER_SM
    for batch, want in zip(batches, packs):
        p = tplan.pack_factor(spec, shape, tile, 4, itemsize, batch,
                              padded=True)
        assert p == want, batch
        assert p <= batch and (p == 1 or p * per <= budget)
        if p > max(1, -(-256 // math.prod(tile))):
            # as few waves as at the cap, and one grid fewer per CTA
            # would take more
            def waves(k):
                return -(-batch // (k * wave))
            assert waves(p) == waves(budget // per) < waves(p - 1)
        assert tplan.smem_bytes(tile, spec, 4, itemsize, padded=True,
                                pack=p) == p * per
        assert tplan.launch_blocks(shape, tile, batch, p) == -(-batch // p) \
            * math.prod(-(-n // t) for n, t in zip(shape, tile))


@settings(max_examples=EXAMPLES, deadline=None, derandomize=True)
@given(st.integers(0, 10 ** 6), st.integers(1, 2), st.integers(1, 4),
       st.sampled_from((2, 4, 8)), st.integers(1, 40))
def test_smem_bytes_with_pack_and_the_padded_lead(seed, ndim, sweeps,
                                                  itemsize, pack):
    """A packed CTA's buffers are its grids' stacked along dim 0, so its
    shared memory is ``pack`` times one grid's, as the layout counts it;
    a padded window starts on its tile's own column (``lead`` 0), so its
    rows are never longer than a pad-free window's."""
    pipe = random_pipeline(seed, ndim, False, 1 + seed % 3)
    rng = np.random.default_rng(seed)
    tile = tuple(int(t) for t in rng.integers(1, 40, size=ndim))
    acc = max(itemsize, 4)
    for padded in (False, True):
        ly = tplan.kernel_layout(tile, pipe, sweeps, itemsize, padded=padded,
                                 pack=pack)
        one = tplan.kernel_layout(tile, pipe, sweeps, itemsize,
                                  padded=padded)
        assert ly.row == one.row and ly.plane == one.plane
        assert ly.elems == tuple(pack * e for e in one.elems)
        assert tplan.smem_bytes(tile, pipe, sweeps, itemsize, padded=padded,
                                pack=pack) == sum(ly.elems) * acc \
            == pack * tplan.smem_bytes(tile, pipe, sweeps, itemsize,
                                       padded=padded)
    pad_ly = tplan.kernel_layout(tile, pipe, sweeps, itemsize, padded=True)
    free_ly = tplan.kernel_layout(tile, pipe, sweeps, itemsize)
    assert pad_ly.lead == 0 and pad_ly.row <= free_ly.row


@pytest.mark.parametrize("shape,tile,itemsize,ptr,path", [
    ((16, 16), (8, 8), 8, 0, "async"),        # 8x8 f64 at sweeps=4
    ((16, 16), (8, 8), 4, 0, "async"),
    ((40, 72), (32, 64), 8, 0, "async"),      # (32, 64) at sweeps=4
    ((520,), (512,), 4, 0, "async"),
    ((2056, 2056), (64, 64), 8, 0, "async"),  # the 2048^2 periodic row
    ((85, 309), (64, 64), 8, 0, "elem"),      # 2472-byte rows
    ((16, 18), (8, 10), 4, 0, "elem"),        # 72-byte rows
    ((16, 16), (8, 8), 8, 8, "elem"),         # data not aligned
    ((16, 16), (8, 6), 4, 0, "elem"),         # tile row of 24 bytes
    ((16, 16), (8, 8), 2, 0, "plain"),        # bf16: widened
])
def test_padded_load_path_rule(shape, tile, itemsize, ptr, path):
    """A padded launch copies the windows inside its input by 16-byte
    cp.async where its rows, tile row and data are 16-byte aligned, else
    by a cp.async per element (f32/f64) or through registers (bf16); the
    pad-free rule keeps element-by-element loads for what is not
    aligned."""
    assert tplan.load_path(shape, tile, itemsize, ptr, padded=True) == path
    assert tplan.load_path(shape, tile, itemsize, ptr) == \
        ("async" if path == "async" else "plain")


# the serving mix's grids (repro.serve.loadgen.mixed_requests) and the
# points per grid a block of sweeps=4 computed with the default tile:
# every application forms tile + 2*rem per dim
_SERVING = (("jacobi2d", "zero", (8, 8), 17976),
            ("jacobi2d", "zero", (32, 64), 17976),
            ("jacobi1d", "zero", (512,), 16396),
            ("reaction_diffusion2d", "reflect", (32, 64), 40496),
            ("advect2d", "periodic", (32, 64), 17976))


@pytest.mark.parametrize("name,boundary,shape,before", _SERVING)
def test_points_per_output_on_the_serving_shapes(name, boundary, shape,
                                                 before):
    """The window kernel's CTAs on a batch of serving grids (the mirror's
    count of the points every application forms, both entries) compute
    at most 1.2x the points per output of a tile fitted to the grid,
    where the default tile computed up to 36x."""
    from _stencil_tile_mirror import window_kernel_block
    spec = _serving_spec(name)
    assert {s.boundary for s in as_stages(spec)} == {boundary}
    sweeps, batch = 4, 3
    tile = tplan.normalize_tile(spec, None, sweeps, 8, shape)
    stages = as_stages(spec)
    rem, fitted = [sweeps * h for h in spec.halo], 0
    for _ in range(sweeps):
        for st_ in stages:
            rem = [r - h for r, h in zip(rem, st_.halo)]
            fitted += math.prod(n + 2 * r for n, r in zip(shape, rem))
    default = tplan.default_tile(spec, sweeps, 8)
    rem, old = [sweeps * h for h in spec.halo], 0
    for _ in range(sweeps):
        for st_ in stages:
            rem = [r - h for r, h in zip(rem, st_.halo)]
            old += math.prod(t + 2 * r for t, r in zip(default, rem))
    assert old == before and old / fitted > 1.8
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (batch,) + shape))
    wide = tuple(sweeps * h for h in spec.halo)
    win = tref.pad_boundary(x, wide, spec.boundary_mode, spec.boundary_value)
    for kwargs, src in (({}, x), ({"origin": (0,) * spec.ndim,
                                   "grid_shape": shape,
                                   "out_shape": shape}, win)):
        got, stats = window_kernel_block(spec, src, tile, sweeps, **kwargs)
        assert stats["points"] <= 1.2 * batch * fitted
        assert torch.equal(got, teng.stencil_sweep_plain(spec, x, tile,
                                                         sweeps))


@pytest.mark.parametrize("name,shape,itemsize,strategy", [
    ("jacobi2d", (8, 8), 8, "padded-window"),
    ("jacobi2d", (32, 64), 4, "padded-window"),
    ("jacobi1d", (512,), 4, "padded-window"),
    ("reaction_diffusion2d", (32, 64), 8, "padded-window"),
    ("heat3d", (8, 12, 16), 4, "padded-window"),
    ("advect2d", (32, 64), 4, "pad-free"),          # periodic: K1
    ("jacobi2d", (72, 72), 8, "pad-free"),          # one window
])
def test_small_grid_strategy_rule_as_measured(name, shape, itemsize,
                                              strategy):
    """Grids smaller than one window (the serving mix) keep the padded
    window (K2/K4 and the host pad), the reference's rule: K1/K3 on the
    unpadded grids, with the same fitted, packed tiles, did not win on
    every such batch on the card.  Periodic grids run pad-free."""
    from repro.core import plan as jplan
    spec = _serving_spec(name)
    assert tplan.ghost_strategy_for(spec, shape, itemsize, 4, None) \
        == strategy
    plan = tplan.lower(spec, shape, _DTYPES[itemsize], backend="cuda",
                       sweeps=4, device="cpu")
    assert plan.ghost_strategy == strategy
    ref = (J_PIPES["advect_diffuse2d"].stages[0] if name == "advect2d"
           else J_SPECS.get(name) or J_PIPES[name])
    assert jplan.ghost_strategy_for(ref, shape, itemsize, 4, plan.tile) \
        == strategy
