"""Fused pipelines in the port vs ``repro``: the chain core, the plain
versions of K3/K4, pipeline plans, the engine, bf16 and the traffic model.

* torch ``masked_window_pipeline`` vs ``repro.core.ref``'s, bitwise in
  f64, over rank 1-3 x each fusable family x sweeps {1,2,3};
* the plain versions of K3/K4 vs the reference's Pallas kernels in
  interpret mode (one case per rank, a tiny grid, a nonzero K4 origin, a
  mixed zero/constant/reflect chain), bitwise in f64;
* pipeline plan fields and the strategy decisions vs ``repro.core.plan``;
* ``CasperEngine(pipe, backend="cuda", device="cpu")`` vs ``repro``'s
  ``CasperEngine(pipe, backend="ref")``, bitwise in f64, over
  PAPER_PIPELINES x 4 boundaries x sweeps {1,2,3} and the staged chain;
  f32 within 1e-5; bf16 (K1-K4) within the reference's 0.07 of the f32
  oracle;
* one test that needs the card, holding K3/K4 and bf16 K1/K2 against
  their plain versions (skipped where CUDA is missing).

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
from repro.core import PAPER_PIPELINES as J_PIPES
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import plan as jplan
from repro.core import ref as jref
from repro.core.stencil import StencilPipeline as JPipeline
from repro.kernels import engine as jeng
from repro_torch import CasperEngine, spec_from_reference
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.kernels import engine as teng

BOUNDARIES = ["zero", "constant(0.75)", "periodic", "reflect"]
SMALL_TILE = (8, 32)
BF16_TOL = 0.07        # the reference's bf16 tolerance (tests/test_kernels.py)


def _chain(names, boundaries, name="chain"):
    """A reference pipeline of paper stencils, stage k on boundaries[k]."""
    return JPipeline(name, tuple(J_SPECS[n].with_boundary(b)
                                 for n, b in zip(names, boundaries)))


def _mixed_rd():
    """reaction_diffusion2d's stages as zero, constant(0.75), reflect: a
    fusable chain in which every restoration takes the next stage's mode."""
    d, r = J_PIPES["reaction_diffusion2d"].stages
    return JPipeline("mixed_rd", (d.with_boundary("zero"),
                                  r.with_boundary("constant(0.75)"),
                                  d.with_boundary("reflect")))


def _nonfusable():
    """advect2d (periodic) then rd_react (reflect): lowers "staged"."""
    return JPipeline("advect_react",
                     (J_PIPES["advect_diffuse2d"].stages[0],
                      J_PIPES["reaction_diffusion2d"].stages[1]))


# ---------------------------------------------------------------------------
# The chain core
# ---------------------------------------------------------------------------
RANK_CHAINS = {1: ("7pt1d", "jacobi1d"), 2: ("blur2d", "jacobi2d", "jacobi2d"),
               3: ("heat3d", "star33_3d")}
FAMILIES = {"zero": ("zero",) * 3, "constant": ("constant(0.75)",) * 3,
            "reflect": ("reflect",) * 3, "periodic": ("periodic",) * 3,
            "mixed": ("zero", "constant(0.75)", "reflect")}
CORE_GRIDS = {1: (41,), 2: (13, 22), 3: (7, 9, 12)}
CORE_TILES = {1: (8,), 2: (4, 8), 3: (2, 4, 4)}


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_masked_window_pipeline_f64_bitwise(rank, family, sweeps):
    """The chain core on a leading batch of windows at per-window origins
    (left edge, interior, right edge), against the JAX core vmapped over
    the same windows (its ``starts`` traced, as inside the kernel)."""
    names = RANK_CHAINS[rank]
    ref = _chain(names, FAMILIES[family][:len(names)])
    port = spec_from_reference(ref)
    grid, out_shape = CORE_GRIDS[rank], CORE_TILES[rank]
    a = np.random.default_rng(12).standard_normal(grid)
    starts_list = [(0,) * rank, tuple(n // 3 for n in grid),
                   tuple(n - t for n, t in zip(grid, out_shape))]
    wide = tuple(sweeps * h for h in port.halo)
    padded = tref.pad_boundary(torch.from_numpy(a), wide, port.boundary_mode,
                               port.boundary_value)
    wins = torch.stack([padded[tuple(slice(s, s + t + 2 * w)
                                     for s, t, w in zip(st, out_shape, wide))]
                        for st in starts_list])
    starts = tuple(torch.tensor([st[d] for st in starts_list])
                   for d in range(rank))
    got = tref.masked_window_pipeline(wins, port.stages, out_shape, sweeps,
                                      starts, grid, torch.float64)

    def one(win, st):
        return jref.masked_window_pipeline(
            win, ref.stages, out_shape, sweeps,
            tuple(st[d] for d in range(rank)), grid, jnp.float64)

    with jax.enable_x64(True):
        want = jax.jit(jax.vmap(one))(
            jnp.asarray(wins.numpy()),
            jnp.asarray(np.array(starts_list), jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_and_run_pipeline_match_reference():
    ref = _mixed_rd()
    a = np.random.default_rng(13).standard_normal((19, 23))
    port = spec_from_reference(ref)
    with jax.enable_x64(True):
        want1 = np.asarray(jref.apply_pipeline(ref, jnp.asarray(a)))
        want4 = np.asarray(jref.run_pipeline(ref, jnp.asarray(a), 4))
    g = torch.from_numpy(a)
    np.testing.assert_array_equal(tref.apply_pipeline(port, g).numpy(), want1)
    np.testing.assert_array_equal(
        tref.apply_pipeline(port.stages, g).numpy(), want1)
    np.testing.assert_array_equal(tref.run_pipeline(port, g, 4).numpy(),
                                  want4)


# ---------------------------------------------------------------------------
# Plain versions of K3/K4 vs the reference kernels (Pallas interpret mode)
# ---------------------------------------------------------------------------
def _k3_cases():
    return [
        # reference pipeline, grid shape, tile, sweeps
        (_chain(("7pt1d", "jacobi1d"), ("reflect",) * 2), (301,), (64,), 2),
        (J_PIPES["reaction_diffusion2d"].with_boundary("constant(0.75)"),
         (37, 70), SMALL_TILE, 2),
        (_chain(("heat3d", "star33_3d"), ("periodic",) * 2), (9, 12, 40),
         (2, 4, 16), 1),
        (J_PIPES["advect_diffuse2d"].with_boundary("zero"), (3, 7),
         SMALL_TILE, 2),                                   # tiny: K4
        (_mixed_rd(), (37, 70), SMALL_TILE, 2),
    ]


@pytest.mark.parametrize("case", range(5))
def test_plain_pipeline_kernels_match_pallas_interpret(case):
    ref, shape, tile, sweeps = _k3_cases()[case]
    port = spec_from_reference(ref)
    a = np.random.default_rng(14).standard_normal(shape)
    strategy = tplan.ghost_strategy_for(port, shape, 8, sweeps, tile)
    assert strategy == jplan.ghost_strategy_for(
        ref, shape, 8, sweeps, tile,
        periodic_budget_bytes=tplan._pm.PERIODIC_WHOLE_GRID_BYTES)
    assert strategy == ("padded-window" if shape == (3, 7) else "pad-free")
    with jax.enable_x64(True):
        want = jeng.pipeline_sweep(ref, jnp.asarray(a), tile=tile,
                                   sweeps=sweeps, interpret=True,
                                   strategy=strategy)
        got = teng.pipeline_sweep(port, torch.from_numpy(a), tile=tile,
                                  sweeps=sweeps, strategy=strategy)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_pipeline_window_kernel_nonzero_origin_matches_interpret():
    """K4 on a shard-like window: interior origin inside a larger grid,
    global-coordinate restoration per the next stage at the real edges."""
    ref = J_PIPES["reaction_diffusion2d"]
    port = spec_from_reference(ref)
    grid_shape, out_shape, origin, sweeps, tile = \
        (40, 64), (20, 30), (20, 34), 2, (8, 16)
    a = np.random.default_rng(15).standard_normal(grid_shape)
    wide = tuple(sweeps * h for h in ref.halo)
    padded = tref.pad_boundary(torch.from_numpy(a), wide, "reflect")
    window = padded[tuple(slice(o, o + n + 2 * w)
                          for o, n, w in zip(origin, out_shape, wide))]
    got = teng.pipeline_window_sweep(port, window, out_shape, origin,
                                     grid_shape, tile=tile, sweeps=sweeps)
    with jax.enable_x64(True):
        want = jeng.pipeline_window_sweep(
            ref, jnp.asarray(window.numpy()), out_shape, origin, grid_shape,
            tile=tile, sweeps=sweeps, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        full = jref.run_pipeline(ref, jnp.asarray(a), sweeps)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(full)[20:40, 34:64])


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------
def _plan_refs():
    out = [(f"{n} {b}", J_PIPES[n].with_boundary(b))
           for n in J_PIPES for b in BOUNDARIES]
    return out + [("advect_react", _nonfusable())]


@pytest.mark.parametrize("label,ref", _plan_refs(),
                         ids=[label for label, _ in _plan_refs()])
def test_pipeline_plan_fields_match_reference(label, ref):
    port = spec_from_reference(ref)
    shape = (40, 70)
    jp = jplan.lower(ref, shape, jnp.float32, backend="pallas", sweeps=3,
                     tile=SMALL_TILE, interpret=True)
    tp = tplan.lower(port, shape, torch.float32, backend="cuda", sweeps=3,
                     tile=SMALL_TILE, device="cpu")
    assert tp.is_pipeline and jp.is_pipeline
    assert tp.halo == jp.halo and tp.deep_halo == jp.deep_halo
    assert tp.fused == jp.fused == ref.fusable
    assert tp.ghost_strategy == jp.ghost_strategy
    assert (tp.ghost_strategy == "staged") == (not ref.fusable)
    assert tp.tile == jp.tile
    for iters in (0, 7, 9, 10):
        assert tp.decompose(iters) == jp.decompose(iters)
    assert (tp.boundary_mode, tp.boundary_value) == \
        (jp.boundary_mode, jp.boundary_value)
    assert tp.factorization is None and jp.factorization is None
    assert tp.program.words == jp.program.words
    assert tp.remainder(2).sweeps == jp.remainder(2).sweeps == 2
    assert len(tp.stages) == len(jp.stages)
    for k in range(len(tp.stages)):
        assert tp.stage_plan(k).sweeps == jp.stage_plan(k).sweeps == 1
        assert tp.stage_plan(k).spec == port.stages[k]
    # the decision under equal tiles and budgets, at both strategies
    if ref.fusable:
        for grid, budget in (((40, 70), 1 << 20), ((6, 40), 1 << 20),
                             ((64, 64), 4 * 64 * 64 - 1)):
            assert tplan.ghost_strategy_for(
                port, grid, 4, 3, SMALL_TILE,
                periodic_budget_bytes=budget) == jplan.ghost_strategy_for(
                ref, grid, 4, 3, SMALL_TILE, periodic_budget_bytes=budget)


def test_shared_memory_sizing_counts_the_stage_chain():
    rd = spec_from_reference(J_PIPES["reaction_diffusion2d"])
    # window 48x144 plus the first intermediate's 46 rows on the window's
    # row pitch, in f64: 106 KB
    assert tplan.smem_bytes((32, 128), rd, 4, 8) == (48 * 144 + 46 * 144) * 8
    assert tplan.default_tile(rd, 4, 8) == (64, 64)
    # one sweep of a two-stage chain still needs the second buffer
    assert tplan.smem_bytes((32, 128), rd, 1, 8) == (36 * 132 + 34 * 132) * 8
    # a single spec at sweeps=1 does not; its 130-column window starts at
    # lead column 1 of a row rounded up to 16 bytes
    j2 = rd.stages[0]
    assert tplan.smem_bytes((32, 128), j2, 1, 8) == 34 * 132 * 8
    # bf16 is computed in f32 in shared memory
    for spec in (rd, j2):
        assert tplan.smem_bytes((32, 128), spec, 4, 2) == \
            tplan.smem_bytes((32, 128), spec, 4, 4)
        assert tplan.default_tile(spec, 4, 2) == tplan.default_tile(spec, 4, 4)


def test_chains_the_kernels_cannot_take_are_refused_at_lowering():
    star = spec_from_reference(J_SPECS["star33_3d"])
    # no Hopper tile fits the shared memory of a deep rank-3 chain
    deep = spec_from_reference(_chain(("star33_3d",) * 2, ("zero",) * 2))
    with pytest.raises(ValueError, match="shared memory"):
        tplan.lower(deep, (16, 16, 64), torch.float64, backend="cuda",
                    sweeps=4, device="cpu")
    # more taps than the kernels' pools hold (3 x 33 > 96)
    many = spec_from_reference(_chain(("star33_3d",) * 3, ("zero",) * 3))
    with pytest.raises(ValueError, match="taps"):
        tplan.lower(many, (16, 16, 64), torch.float64, backend="cuda",
                    sweeps=1, device="cpu")
    # five stages
    five = spec_from_reference(_chain(("jacobi2d",) * 5, ("zero",) * 5))
    with pytest.raises(ValueError, match="stages"):
        tplan.lower(five, (16, 64), torch.float64, backend="cuda", sweeps=1,
                    device="cpu")
    # the oracle backend takes them all
    tplan.lower(many, (16, 16, 64), torch.float64, backend="ref",
                device="cpu")
    assert star.n_taps == 33


def test_pipeline_window_sweep_refuses_a_nonfusable_chain():
    port = spec_from_reference(_nonfusable())
    g = torch.zeros((12, 40), dtype=torch.float64)
    with pytest.raises(ValueError, match="cannot run fused"):
        teng.pipeline_window_sweep(port, tref.pad_boundary(g, (2, 2)),
                                   (12, 40), (0, 0), (12, 40), SMALL_TILE)
    with pytest.raises(ValueError, match="cannot run fused"):
        teng.pipeline_sweep(port, g, strategy="pad-free")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_pipeline_run(label, iters):
    """``repro``'s ``CasperEngine(backend="ref")`` on the shared input
    (its bits do not depend on ``sweeps``)."""
    ref = dict(_plan_refs())[label]
    a = np.random.default_rng(16).standard_normal((37, 53))
    with jax.enable_x64(True):
        out = JEngine(ref, backend="ref", sweeps=3).run(jnp.asarray(a),
                                                        iters=iters)
        return ref, a, np.asarray(out)


@pytest.mark.parametrize("label", [label for label, _ in _plan_refs()])
def test_engine_pipeline_on_cpu_bitwise_matches_reference(label):
    """iters=7 at sweeps {1,2,3}: full fused blocks plus a remainder;
    default tiles (K4 on this grid) and a small explicit tile (K3)."""
    ref, a, want = _reference_pipeline_run(label, 7)
    port = spec_from_reference(ref)
    for sweeps in (1, 2, 3):
        for tile in (None, SMALL_TILE):
            eng = CasperEngine(port, backend="cuda", device="cpu",
                               sweeps=sweeps, tile=tile)
            got = eng.run(a, iters=7)
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{sweeps} {tile}")
    got = CasperEngine(port, backend="ref", device="cpu").run(a, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.run_pipeline(port, torch.from_numpy(a), 7).numpy(), want)


def test_engine_pipeline_strategies_cover_both_fused_kernels():
    port = spec_from_reference(J_PIPES["reaction_diffusion2d"])
    eng = CasperEngine(port, backend="cuda", device="cpu", sweeps=2)
    assert eng.plan_for((37, 53), torch.float64).ghost_strategy == \
        "padded-window"
    assert eng.plan_for((200, 300), torch.float64).ghost_strategy == \
        "pad-free"
    assert eng.program.words == tplan.lower(
        port, (37, 53), torch.float64, device="cpu").program.words


def test_engine_mixed_chain_and_batch_bitwise():
    ref = _mixed_rd()
    port = spec_from_reference(ref)
    a = np.random.default_rng(17).standard_normal((3, 37, 70))
    got = CasperEngine(port, backend="cuda", device="cpu", sweeps=3,
                       tile=SMALL_TILE).run(a, iters=7)
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jref.run_pipeline(ref, jnp.asarray(x),
                                                      7)) for x in a])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(J_PIPES))
def test_engine_pipeline_f32_within_tolerance(name):
    ref = J_PIPES[name]
    a = np.random.default_rng(18).standard_normal((40, 70)).astype(np.float32)
    got = CasperEngine(spec_from_reference(ref), backend="cuda",
                       device="cpu", sweeps=3).run(a, iters=7)
    want = JEngine(ref, backend="ref").run(jnp.asarray(a), iters=7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


BF16_CASES = [
    # reference spec or pipeline, boundary, strategy
    ("jacobi2d", "reflect", "pad-free"),                       # K1
    ("blur2d", "constant(0.75)", "padded-window"),             # K2
    ("reaction_diffusion2d", "reflect", "pad-free"),           # K3
    ("advect_diffuse2d", "periodic", "padded-window"),         # K4
]


@pytest.mark.parametrize("name,boundary,strategy", BF16_CASES)
def test_bf16_within_reference_tolerance_of_f32_oracle(name, boundary,
                                                       strategy):
    """bf16 in, bf16 out, f32 inside: two fused sweeps against the f32
    oracle on the bf16-rounded input, at the reference's bf16 tolerance."""
    ref = (J_PIPES.get(name) or J_SPECS[name]).with_boundary(boundary)
    port = spec_from_reference(ref)
    a = np.random.default_rng(19).standard_normal((40, 70))
    g = torch.from_numpy(a).to(torch.bfloat16)
    sweep = teng.pipeline_sweep if name in J_PIPES else teng.stencil_sweep
    got = sweep(port, g, tile=SMALL_TILE, sweeps=2, strategy=strategy)
    assert got.dtype == torch.bfloat16 and got.shape == g.shape
    run = jref.run_pipeline if name in J_PIPES else jref.run_iterations
    want = np.asarray(run(ref, jnp.asarray(g.float().numpy()), 2))
    err = np.abs(got.float().numpy() - want).max()
    assert err < BF16_TOL, err
    # the engine takes bf16 too, with f32-sized shared memory
    eng = CasperEngine(port, backend="cuda", device="cpu", sweeps=2)
    assert eng.plan_for(g.shape, g.dtype).tile == \
        eng.plan_for(g.shape, torch.float32).tile
    out = eng.run(g, iters=2)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - want).max() < BF16_TOL


def test_hbm_pipeline_traffic_matches_reference_model():
    for name, ref in J_PIPES.items():
        for shape in ((40, 70), (2048, 2048)):
            for sweeps in (1, 4):
                want = jeng.hbm_pipeline_traffic(ref, shape, SMALL_TILE,
                                                 sweeps, 8)
                got = teng.hbm_pipeline_traffic(spec_from_reference(ref),
                                                shape, SMALL_TILE, sweeps, 8)
                assert got == want
    rd = spec_from_reference(J_PIPES["reaction_diffusion2d"])
    assert teng.hbm_pipeline_traffic(rd, (64, 256), sweeps=4, itemsize=8) \
        == teng.hbm_pipeline_traffic(rd, (64, 256), (64, 64), 4, 8)


# ---------------------------------------------------------------------------
# On the card: K3/K4 (and bf16 K1/K2) against their plain versions
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_pipeline_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(20)
    chains = [J_PIPES[n].with_boundary(b) for n in J_PIPES
              for b in BOUNDARIES] + [_mixed_rd()]
    for ref in chains:
        port = spec_from_reference(ref)
        g = torch.from_numpy(rng.standard_normal((77, 301))).cuda()
        for dtype in (torch.float64, torch.bfloat16):
            x = g.to(dtype)
            for sweeps in (1, 3):
                tile = tplan.default_tile(port, sweeps, x.element_size())
                wide = tuple(sweeps * h for h in port.halo)
                window = tref.pad_boundary(x, wide, port.boundary_mode,
                                           port.boundary_value)
                for kernel in ("K3", "K4"):
                    before = teng.LAUNCHES[kernel]
                    if kernel == "K3":
                        got = teng.pipeline_sweep(port, x, sweeps=sweeps,
                                                  strategy="pad-free")
                        want = teng.pipeline_sweep_plain(port, x, tile,
                                                         sweeps)
                    else:
                        got = teng.pipeline_window_sweep(
                            port, window, x.shape, (0, 0), x.shape,
                            sweeps=sweeps)
                        want = teng.pipeline_window_sweep_plain(
                            port, window, x.shape, (0, 0), x.shape, tile,
                            sweeps)
                    assert teng.LAUNCHES[kernel] == before + 1
                    assert torch.equal(got, want), (ref.name, dtype, sweeps,
                                                    kernel)
    spec = spec_from_reference(J_SPECS["blur2d"].with_boundary("reflect"))
    x = torch.from_numpy(rng.standard_normal((77, 301))).cuda().bfloat16()
    for strategy in ("pad-free", "padded-window"):
        got = teng.stencil_sweep(spec, x, sweeps=2, strategy=strategy)
        want = teng.stencil_sweep_plain(spec, x, tplan.default_tile(
            spec, 2, 2), 2)
        assert torch.equal(got, want), strategy
