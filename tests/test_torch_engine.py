"""The port's plans, kernels' plain versions and engine vs ``repro``.

* the plain versions of K1/K2 vs the reference's Pallas kernels in
  interpret mode (one case per rank, a tiny grid, a nonzero K2 origin);
* plan fields and the ghost-strategy decision vs ``repro.core.plan``;
* ``CasperEngine(device="cpu", backend="cuda")`` vs ``repro``'s
  ``CasperEngine(backend="ref")``, bitwise in f64, over the paper
  stencils x 4 boundaries x sweeps {1,2,3} with a remainder;
* the engine's cache, freezing, ``iters=0`` copy and device rules;
* one test that needs the card, holding each kernel against its plain
  version (skipped where CUDA is missing).

Inputs come from ``np.random.default_rng``; JAX f64 is scoped with
``jax.enable_x64(True)``.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import CasperEngine as JEngine
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import plan as jplan
from repro.core import ref as jref
from repro.kernels import engine as jeng
from repro_torch import CasperEngine, grid_from_numpy, spec_from_reference
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.kernels import engine as teng

BOUNDARIES = ["zero", "constant(0.75)", "periodic", "reflect"]
# Small odd shapes that split unevenly into the small explicit tiles.
SHAPES = {1: (300,), 2: (40, 70), 3: (13, 22, 70)}
SMALL_TILES = {1: (64,), 2: (8, 32), 3: (2, 4, 16)}


def _port(ref_spec):
    return spec_from_reference(ref_spec)


# ---------------------------------------------------------------------------
# Plain versions of K1/K2 vs the reference kernels (Pallas interpret mode)
# ---------------------------------------------------------------------------
KERNEL_CASES = [
    # name, boundary, grid shape, tile, sweeps
    ("7pt1d", "reflect", (301,), (64,), 2),
    ("blur2d", "constant(0.75)", (37, 70), (8, 32), 2),
    ("heat3d", "periodic", (9, 12, 40), (2, 4, 16), 2),
    ("star33_3d", "zero", (3, 5, 7), (2, 4, 16), 2),       # tiny: K2
]


@pytest.mark.parametrize("name,boundary,shape,tile,sweeps", KERNEL_CASES)
def test_plain_kernels_match_pallas_interpret(name, boundary, shape, tile,
                                              sweeps):
    ref = J_SPECS[name].with_boundary(boundary)
    port = _port(ref)
    a = np.random.default_rng(4).standard_normal(shape)
    strategy = tplan.ghost_strategy_for(port, shape, 8, sweeps, tile)
    assert strategy == jplan.ghost_strategy_for(
        ref, shape, 8, sweeps, tile,
        periodic_budget_bytes=tplan._pm.PERIODIC_WHOLE_GRID_BYTES)
    with jax.enable_x64(True):
        want = jeng.stencil_sweep(ref, jnp.asarray(a), tile=tile,
                                  sweeps=sweeps, interpret=True,
                                  strategy=strategy)
        got = teng.stencil_sweep(port, torch.from_numpy(a), tile=tile,
                                 sweeps=sweeps, strategy=strategy)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_window_kernel_nonzero_origin_matches_pallas_interpret():
    """K2 on a shard-like window: interior origin inside a larger grid,
    global-coordinate ghost restoration at the grid's real edges."""
    ref = J_SPECS["jacobi2d"].with_boundary("reflect")
    port = _port(ref)
    grid_shape, out_shape, origin, sweeps, tile = \
        (40, 64), (20, 30), (20, 34), 3, (8, 16)
    a = np.random.default_rng(5).standard_normal(grid_shape)
    wide = tuple(sweeps * h for h in ref.halo)
    padded = tref.pad_boundary(torch.from_numpy(a), wide, "reflect")
    window = padded[tuple(slice(o, o + n + 2 * w)
                          for o, n, w in zip(origin, out_shape, wide))]
    got = teng.stencil_window_sweep(port, window, out_shape, origin,
                                    grid_shape, tile=tile, sweeps=sweeps)
    with jax.enable_x64(True):
        want = jeng.stencil_window_sweep(
            ref, jnp.asarray(window.numpy()), out_shape, origin, grid_shape,
            tile=tile, sweeps=sweeps, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # and both equal the whole-grid oracle on that block
        full = jref.run_iterations(ref, jnp.asarray(a), sweeps)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(full)[20:40, 34:64])


# ---------------------------------------------------------------------------
# Plans and the ghost-strategy decision
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", list(J_SPECS))
def test_plan_fields_match_reference(name, boundary):
    ref = J_SPECS[name].with_boundary(boundary)
    port = _port(ref)
    shape, tile = SHAPES[ref.ndim], SMALL_TILES[ref.ndim]
    jp = jplan.lower(ref, shape, jnp.float32, backend="pallas", sweeps=3,
                     tile=tile, interpret=True)
    tp = tplan.lower(port, shape, torch.float32, backend="cuda", sweeps=3,
                     tile=tile, device="cpu")
    assert tp.tile == jp.tile == tile
    assert tp.halo == jp.halo and tp.deep_halo == jp.deep_halo
    for iters in (0, 7, 9, 10):
        assert tp.decompose(iters) == jp.decompose(iters)
    assert (tp.boundary_mode, tp.boundary_value) == \
        (jp.boundary_mode, jp.boundary_value)
    assert tp.program.words == jp.program.words
    assert tp.factorization.structure == jp.factorization.structure
    assert tp.remainder(1).sweeps == jp.remainder(1).sweeps == 1


STRATEGY_CASES = [
    # name, boundary, shape, itemsize, sweeps, tile, budget
    ("jacobi2d", "zero", (70, 130), 4, 1, (32, 64), 1 << 20),
    ("jacobi2d", "zero", (3, 7), 4, 3, (32, 64), 1 << 20),
    ("jacobi2d", "reflect", (34, 66), 8, 1, (32, 64), 1 << 20),   # win == grid
    ("jacobi2d", "reflect", (33, 66), 8, 1, (32, 64), 1 << 20),   # one short
    ("blur2d", "constant(0.75)", (40, 72), 8, 2, (32, 64), 1 << 20),
    ("heat3d", "periodic", (16, 16, 16), 8, 4, (8, 16, 32), 32768),
    ("heat3d", "periodic", (16, 16, 16), 8, 4, (8, 16, 32), 32767),
    ("jacobi1d", "periodic", (4,), 4, 4, (4096,), 16),          # at budget
    ("jacobi1d", "periodic", (5,), 4, 4, (4096,), 16),          # above
    ("star33_3d", "zero", (18, 20, 48), 8, 4, (2, 4, 32), 1),
    ("star33_3d", "zero", (18, 20, 47), 8, 4, (2, 4, 32), 1),
]


@pytest.mark.parametrize("name,boundary,shape,itemsize,sweeps,tile,budget",
                         STRATEGY_CASES)
def test_ghost_strategy_decision_matches_reference(name, boundary, shape,
                                                   itemsize, sweeps, tile,
                                                   budget):
    ref = J_SPECS[name].with_boundary(boundary)
    want = jplan.ghost_strategy_for(ref, shape, itemsize, sweeps, tile,
                                    periodic_budget_bytes=budget)
    got = tplan.ghost_strategy_for(_port(ref), shape, itemsize, sweeps, tile,
                                   periodic_budget_bytes=budget)
    assert got == want


def test_hopper_tiles_fit_shared_memory_and_explicit_misfit_raises():
    spec = _port(J_SPECS["star33_3d"])
    for sweeps in (1, 2, 4):
        for itemsize in (4, 8):
            tile = tplan.default_tile(spec, sweeps, itemsize)
            assert tplan.smem_bytes(tile, spec, sweeps, itemsize) \
                <= tplan._pm.H100_SMEM_PER_BLOCK
    # the reference's Volta-shaped GPU tile does not fit at sweeps=4 f64
    with pytest.raises(ValueError, match="shared memory"):
        tplan.lower(spec, (64, 64, 64), torch.float64, backend="cuda",
                    sweeps=4, tile=(4, 8, 64), device="cpu")


def test_not_ported_paths_raise_with_their_roadmap_item(monkeypatch):
    from repro_torch import PAPER_PIPELINES
    spec = _port(J_SPECS["jacobi2d"])
    pipe = PAPER_PIPELINES["reaction_diffusion2d"]
    with pytest.raises(NotImplementedError, match="item 9"):
        tplan.lower(spec, (8, 8), torch.float64, mesh=object(),
                    grid_axes=("x", None), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        CasperEngine(spec, backend="vm", device="cpu")
    eng = CasperEngine(spec, backend="cuda", device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        eng.analyze((8, 8))
    with pytest.raises(NotImplementedError, match="item 9"):
        eng.distributed_fn(None, ("x", None))
    monkeypatch.setenv("CASPER_SLAB_BUDGET", "64")
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.run(np.zeros((8, 8)), iters=1)
    with pytest.raises(NotImplementedError, match="item 7"):
        CasperEngine(pipe, backend="cuda", device="cpu").run(
            np.zeros((8, 8)), iters=1)
    monkeypatch.delenv("CASPER_SLAB_BUDGET")
    monkeypatch.setenv("CASPER_VERIFY", "strict")
    with pytest.raises(NotImplementedError, match="item 10"):
        tplan.lower(spec, (8, 9), torch.float64, device="cpu")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_run(name, boundary, iters):
    """``repro``'s ``CasperEngine(backend="ref")`` on the shared input.
    The ref backend chains single oracle applications, so its bits do
    not depend on ``sweeps``; one run per (spec, boundary) serves the
    whole sweeps axis."""
    ref = J_SPECS[name].with_boundary(boundary)
    a = np.random.default_rng(6).standard_normal(SHAPES[ref.ndim])
    with jax.enable_x64(True):
        out = JEngine(ref, backend="ref", sweeps=3).run(jnp.asarray(a),
                                                        iters=iters)
        return a, np.asarray(out)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", list(J_SPECS))
def test_engine_cuda_backend_on_cpu_bitwise_matches_reference(name,
                                                              boundary):
    """iters=7: q full fused blocks plus a remainder for every sweeps;
    default Hopper tiles (the padded window on these small grids) and
    small explicit tiles (mostly the pad-free kernel)."""
    ref = J_SPECS[name].with_boundary(boundary)
    a, want = _reference_run(name, boundary, 7)
    for sweeps in (1, 2, 3):
        for tile in (None, SMALL_TILES[ref.ndim]):
            eng = CasperEngine(_port(ref), backend="cuda", device="cpu",
                               sweeps=sweeps, tile=tile)
            got = eng.run(grid_from_numpy(a), iters=7)
            assert got.dtype == torch.float64 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{sweeps} {tile}")
    # the port's ref backend agrees too
    got = CasperEngine(_port(ref), backend="ref", device="cpu").run(a, 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["jacobi1d", "blur2d", "heat3d"])
def test_engine_batched_grid_one_launch_axis(name):
    ref = J_SPECS[name].with_boundary("reflect")
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3,) + SHAPES[ref.ndim])
    eng = CasperEngine(_port(ref), backend="cuda", device="cpu", sweeps=2,
                       tile=SMALL_TILES[ref.ndim])
    got = eng.run(a, iters=5)
    with jax.enable_x64(True):
        run = JEngine(ref, backend="ref").run
        want = np.stack([np.asarray(run(jnp.asarray(x), iters=5))
                         for x in a])
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_f32_matches_reference_within_tolerance():
    ref = J_SPECS["blur2d"].with_boundary("periodic")
    a = np.random.default_rng(8).standard_normal((40, 70)).astype(np.float32)
    got = CasperEngine(_port(ref), backend="cuda", device="cpu",
                       sweeps=3).run(a, iters=7)
    want = JEngine(ref, backend="ref").run(jnp.asarray(a), iters=7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_second_identical_engine_zero_lowers():
    spec = _port(J_SPECS["heat3d"].with_boundary("periodic"))
    a = np.random.default_rng(9).standard_normal((9, 10, 40))
    e1 = CasperEngine(spec, backend="cuda", device="cpu", sweeps=3)
    out1 = e1.run(a, iters=7)
    before = tplan.plan_cache_stats()
    e2 = CasperEngine(spec, backend="cuda", device="cpu", sweeps=3)
    out2 = e2.run(a, iters=7)
    after = tplan.plan_cache_stats()
    assert after["lowers"] == before["lowers"]
    assert after["hits"] > before["hits"]
    assert e1._run is e2._run
    assert torch.equal(out1, out2)


def test_engine_frozen_after_init():
    eng = CasperEngine(_port(J_SPECS["jacobi2d"]), backend="cuda",
                       device="cpu", sweeps=2)
    for attr, value in (("sweeps", 4), ("backend", "ref"), ("tile", (8, 8)),
                        ("device", torch.device("cpu"))):
        with pytest.raises(AttributeError, match="frozen"):
            setattr(eng, attr, value)
    assert eng.sweeps == 2
    assert eng.init_stencilcode() == eng.program.words


def test_iters_zero_returns_a_copy():
    spec = _port(J_SPECS["jacobi2d"])
    g = torch.from_numpy(np.random.default_rng(10).standard_normal((9, 12)))
    for backend in ("ref", "cuda"):
        out = CasperEngine(spec, backend=backend, device="cpu").run(g, 0)
        assert torch.equal(out, g)
        assert out.data_ptr() != g.data_ptr()
        out += 1.0
        assert not torch.equal(out, g)


def test_default_device_is_cuda_and_never_falls_back():
    spec = _port(J_SPECS["jacobi2d"])
    if torch.cuda.is_available():
        assert CasperEngine(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CasperEngine(spec)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CasperEngine(spec, backend="cuda", device="cuda")
    assert CasperEngine(spec, device="cpu").device.type == "cpu"


def test_kernel_arguments_reject_extents_past_int32():
    spec = _port(J_SPECS["jacobi1d"])
    big = (2 ** 31,)
    with pytest.raises(ValueError, match="below 2"):
        teng._args(spec, False, 1, 1, big, (4096,), big, big, (0,), 8, False)


def test_hbm_traffic_matches_reference_model():
    for name, spec in J_SPECS.items():
        tile = SMALL_TILES[spec.ndim]
        for sweeps in (1, 4):
            want = jeng.hbm_traffic(spec, SHAPES[spec.ndim], tile, sweeps, 8)
            got = teng.hbm_traffic(_port(spec), SHAPES[spec.ndim], tile,
                                   sweeps, 8)
            assert got == want


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(11)
    for name, spec in J_SPECS.items():
        for boundary in BOUNDARIES:
            port = _port(spec.with_boundary(boundary))
            shape = {1: (5001,), 2: (77, 301), 3: (37, 45, 101)}[port.ndim]
            g = torch.from_numpy(rng.standard_normal(shape)).cuda()
            for sweeps in (1, 3):
                tile = tplan.default_tile(port, sweeps, 8)
                for strategy, kernel in (("pad-free", "K1"),
                                         ("padded-window", "K2")):
                    before = teng.LAUNCHES[kernel]
                    got = teng.stencil_sweep(port, g, sweeps=sweeps,
                                             strategy=strategy)
                    assert teng.LAUNCHES[kernel] == before + 1
                    want = teng.stencil_sweep_plain(port, g, tile, sweeps)
                    assert torch.equal(got, want), (name, boundary, sweeps,
                                                    kernel)
