"""``tile="auto"`` in the port vs ``repro``: the calibration, the Hopper
tile cost model, the autotuner and its disk cache, and the leftovers of
the kernels package (ROADMAP Queue 1 items 6 and 15).

* ``CASPER_CALIBRATION`` parsed, filtered and validated as
  ``repro.core.perfmodel`` does on the reference's GPU keys;
* ``TuneResult.as_dict`` with the reference's schema, the
  ``CASPER_TUNE_CACHE`` counters of ``tests/test_engine.py`` on the plain
  versions, and a CPU tune's key apart from a card's;
* the model against what was measured on an H100 (``tools/tile_probe.py``;
  PERF.md §6): the 2-D tile order at 8192^2, the fitted tile on 8x8 grids,
  the 3-D defaults; ``inf`` exactly where ``plan._check_tile_fits``
  refuses; the memo re-ranked when the calibration changes;
* ``CasperEngine(..., tile="auto", device="cpu")`` bitwise equal in f64 to
  ``repro``'s ``backend="ref"``, one lowering and one autotune per plan;
* ``plan.runner_cache_stats``, ``kernels.engine.run_sweeps``, the
  deprecated ``stencil1d/2d/3d`` shims and ``kernels/ref.py`` aliases, and
  the numpy oracles, each held against its ``repro`` counterpart.

Inputs come from ``np.random.default_rng``; JAX f64 is scoped with
``jax.enable_x64(True)``.
"""
import json
import math
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.kernels as jkernels
from repro.core import CasperEngine as JEngine
from repro.core import PAPER_PIPELINES as J_PIPES
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.core import ref as jref
from repro.kernels import engine as jeng
from repro.kernels import tune as jtune
from repro_torch import CasperEngine, grid_from_numpy, spec_from_reference
from repro_torch import kernels as tkernels
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.kernels import engine as teng
from repro_torch.kernels import tune as ttune

BOUNDARIES = ["zero", "constant(0.75)", "periodic", "reflect"]
SHAPES = {1: (300,), 2: (40, 70), 3: (13, 22, 70)}
GPU_KEYS = ("gpu_bw", "gpu_launch_s", "gpu_cta_step_s", "gpu_peak_flops_f32",
            "gpu_n_sms")


def _port(ref_spec):
    return spec_from_reference(ref_spec)


def _gpu(cal):
    """A calibration (dict or fingerprint) on the reference's GPU keys."""
    return {k: v for k, v in dict(cal).items() if k in GPU_KEYS}


# ---------------------------------------------------------------------------
# CASPER_CALIBRATION
# ---------------------------------------------------------------------------
INLINE = [
    '{"gpu_bw": 1e6, "provenance": "test-rig"}',
    '{"gpu_launch_s": 0.0, "gpu_cta_step_s": 1.5e-8, "gpu_n_sms": 0.5}',
    '{"gpu_peak_flops_f32": 2e13, "gpu_bw": 3.0e12, "gpu_l2_bw": 6e12}',
    '{"tpu_grid_step_s": 0.0, "gpu_bw": 2.5e12}',
    '{}',
]


@pytest.mark.parametrize("raw", INLINE)
def test_calibration_matches_reference_on_gpu_keys(raw, monkeypatch):
    monkeypatch.setenv(tpm.CALIBRATION_ENV, raw)
    assert tpm.CALIBRATION_ENV == jpm.CALIBRATION_ENV
    assert _gpu(tpm.calibration()) == _gpu(jpm.calibration())
    assert _gpu(tpm.calibration_fingerprint()) == _gpu(
        jpm.calibration_fingerprint())
    # the port drops the reference's tpu_* keys like unknown ones
    assert all(k.startswith("gpu_") for k in tpm.calibration())


def test_calibration_from_a_file_matches_reference(tmp_path, monkeypatch):
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps({"gpu_bw": 3.01e12, "gpu_cta_step_s": 1e-8,
                                "gpu_plane_step_s": 1.2e-6,
                                "fitted_on": "an H100"}))
    monkeypatch.setenv(tpm.CALIBRATION_ENV, str(path))
    assert tpm.calibration() == {"gpu_bw": 3.01e12, "gpu_cta_step_s": 1e-8,
                                 "gpu_plane_step_s": 1.2e-6}
    assert _gpu(tpm.calibration()) == _gpu(jpm.calibration())
    assert _gpu(tpm.calibration_fingerprint()) == _gpu(
        jpm.calibration_fingerprint())


BAD = ['{"gpu_bw": 0}', '{"gpu_bw": -1}', '{"gpu_bw": NaN}',
       '{"gpu_bw": Infinity}', '{"gpu_n_sms": 0}',
       '{"gpu_launch_s": -1e-9}', '{"gpu_cta_step_s": -1}', '{broken',
       '{"gpu_bw": "fast"}']


@pytest.mark.parametrize("raw", BAD)
def test_bad_calibration_raises_as_reference(raw, monkeypatch):
    monkeypatch.setenv(tpm.CALIBRATION_ENV, raw)
    with pytest.raises(ValueError) as want:
        jpm.calibration()
    with pytest.raises(ValueError) as got:
        tpm.calibration()
    assert str(got.value) == str(want.value)


def test_calibration_unset_missing_file_and_zero_overheads(monkeypatch):
    monkeypatch.setenv(tpm.CALIBRATION_ENV, "/nonexistent/calibration.json")
    with pytest.raises(OSError):
        jpm.calibration()
    with pytest.raises(OSError):
        tpm.calibration()
    monkeypatch.setenv(tpm.CALIBRATION_ENV, '{"gpu_plane_step_s": 0.0}')
    assert tpm.calibration() == {"gpu_plane_step_s": 0.0}
    monkeypatch.delenv(tpm.CALIBRATION_ENV)
    assert tpm.calibration() == {} and tpm.calibration_fingerprint() == ()


# ---------------------------------------------------------------------------
# The cost model against the H100's measured order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["jacobi2d", "reaction_diffusion2d"])
def test_model_ranks_64x64_over_32x128_at_8192(name):
    """64x64 ahead of 32x128 at 8192^2, f64, sweeps=4, for K1 jacobi2d and
    K3 reaction_diffusion2d, as measured on an H100 (``tools/tile_probe.py``
    and ``chip_smoke.py`` phase 3, within 1-4%): fewer points per output
    and still two CTAs per SM; both well ahead of the smaller tiles."""
    spec = _port(J_SPECS[name] if name in J_SPECS else J_PIPES[name])
    tune = (ttune.autotune_pipeline if name in J_PIPES else ttune.autotune)
    res = tune(spec, (8192, 8192), sweeps=4, itemsize=8)
    cost = dict(res.table)
    assert res.tile == (64, 64)
    assert cost[(64, 64)] < cost[(32, 128)] < cost[(32, 64)] < cost[(16, 64)]


def test_model_prefers_the_fitted_tile_on_8x8_grids(monkeypatch):
    """A tile fitted to an 8x8 grid beat the 64x64 default 23x on the
    device (PERF.md §6): the model prices the default's halo around the
    grid, and the tuner draws the fitted tile first."""
    spec = _port(J_SPECS["jacobi2d"])
    res = ttune.autotune(spec, (8, 8), sweeps=4, itemsize=8)
    assert res.tile == (8, 8)
    assert [t for t, _ in res.table] == [(8, 8), (4, 8), (1, 8)]
    # the device's share of a batch, without the host's launch floor
    monkeypatch.setenv(tpm.CALIBRATION_ENV, '{"gpu_launch_s": 0}')
    fitted = tpm.cuda_tile_cost(spec, (8, 8), (8, 8), 4, 8)
    assert fitted * 10 < tpm.cuda_tile_cost(spec, (8, 8), (64, 64), 4, 8)


@pytest.mark.parametrize("name,shape,tile", [
    ("star33_3d", (256, 256, 64), (32, 16, 16)),
    ("heat3d", (512, 512, 256), (32, 32, 32)),
])
def test_model_keeps_the_3d_defaults(name, shape, tile):
    spec = _port(J_SPECS[name])
    assert tplan.default_tile(spec, 4, 8) == tile
    assert ttune.autotune(spec, shape, sweeps=4, itemsize=8).tile == tile


@pytest.mark.parametrize("name", list(J_SPECS) + list(J_PIPES))
@pytest.mark.parametrize("sweeps,itemsize", [(1, 4), (4, 8), (8, 8),
                                             (4, 2)])
def test_model_refuses_exactly_what_lowering_refuses(name, sweeps, itemsize):
    spec = _port(J_SPECS[name] if name in J_SPECS else J_PIPES[name])
    cost = (tpm.cuda_pipeline_tile_cost if name in J_PIPES
            else tpm.cuda_tile_cost)
    shape = {1: (4096,), 2: (256, 256), 3: (64, 64, 64)}[spec.ndim]
    for tile in tplan.HOPPER_TILES[spec.ndim] + ((64, 128), (4, 64, 64)):
        if len(tile) != spec.ndim:
            continue
        try:
            tplan._check_tile_fits(spec, tile, sweeps, itemsize)
            fits = True
        except ValueError:
            fits = False
        assert math.isinf(cost(spec, shape, tile, sweeps, itemsize)) \
            == (not fits)


def test_no_fitting_candidate_raises():
    spec = _port(J_SPECS["blur2d"])
    with pytest.raises(ValueError, match="no candidate tile fits H100 shared "
                                         "memory for blur2d sweeps=40"):
        ttune.autotune(spec, (2048, 2048), sweeps=40, itemsize=8)
    with pytest.raises(ValueError, match="no candidate tile fits"):
        tplan.lower(spec, (2048, 2048), torch.float64, backend="cuda",
                    sweeps=40, tile="auto", device="cpu")


def test_candidates_are_fitted_and_deduplicated():
    spec = _port(J_SPECS["heat3d"])
    cands = ttune.candidate_tiles(3, (8, 12, 16), spec=spec, sweeps=4,
                                  itemsize=8)
    assert cands[0] == tplan.normalize_tile(spec, None, 4, 8, (8, 12, 16))
    assert len(set(cands)) == len(cands)
    assert all(t[1] <= 12 and t[2] <= 16 for t in cands)
    # a shallow grid cuts the 32-plane chunk to its depth less the window's
    assert ttune.candidate_tiles(3, (40, 64, 64), spec=spec, sweeps=4,
                                 itemsize=8)[0] == (32, 32, 32)
    assert ttune.candidate_tiles(3, (30, 64, 64), spec=spec, sweeps=4,
                                 itemsize=8)[0] == (22, 32, 32)
    assert ttune.candidate_tiles(2) == tplan.HOPPER_TILES[2]
    # rows rounded up to a 16-byte chunk: 2 f64, 4 f32, 1 bf16
    jac = _port(J_SPECS["jacobi2d"])
    assert (7, 8) in ttune.candidate_tiles(2, (7, 7), spec=jac, itemsize=8)
    assert (7, 8) in ttune.candidate_tiles(2, (7, 5), spec=jac, itemsize=4)
    assert (7, 7) in ttune.candidate_tiles(2, (7, 7), spec=jac, itemsize=2)
    with pytest.raises(ValueError, match="tuning backend"):
        ttune.candidate_tiles(2, backend="pallas")


def test_autotune_memo_follows_the_calibration(monkeypatch):
    spec = _port(J_SPECS["jacobi2d"])
    monkeypatch.delenv(tpm.CALIBRATION_ENV, raising=False)
    ttune._autotune.cache_clear()
    base = ttune.autotune(spec, (2048, 2048), sweeps=4, itemsize=8)
    assert ttune.autotune(spec, (2048, 2048), 4, 8) is base
    monkeypatch.setenv(tpm.CALIBRATION_ENV, '{"gpu_bw": 1e6}')
    slowed = ttune.autotune(spec, (2048, 2048), sweeps=4, itemsize=8)
    assert slowed is not base and slowed.cost_s > base.cost_s * 100
    assert ttune._autotune.cache_info().misses == 2
    monkeypatch.delenv(tpm.CALIBRATION_ENV)
    assert ttune.autotune(spec, (2048, 2048), 4, 8) is base


def test_tune_result_schema_matches_reference():
    table = (((32, 64), 1e-4), ((64, 64), 2e-4))
    got = ttune.TuneResult((32, 64), 1e-4, table).as_dict()
    want = jtune.TuneResult((32, 64), 1e-4, table).as_dict()
    assert got == want
    assert ttune.TuneResult((32, 64), 1e-4, table, True).as_dict() == \
        jtune.TuneResult((32, 64), 1e-4, table, True).as_dict()


def test_fit_calibration_slope_and_clamp():
    timed = [{"n_ctas": 1024, "seconds": 1.0e-3},
             {"n_ctas": 4096, "seconds": 1.3e-3},
             {"n_ctas": 2048, "seconds": 0.9e-3}]
    cal = ttune.fit_calibration(3.0e12, timed)
    assert cal == {"gpu_bw": 3.0e12,
                   "gpu_cta_step_s": pytest.approx(0.3e-3 / 3072)}
    # noise can invert the slope: clamped to 0, and no SM count is set
    timed[1]["seconds"] = 0.5e-3
    assert ttune.fit_calibration(3.0e12, timed)["gpu_cta_step_s"] == 0.0
    assert ttune.fit_calibration(3e12, timed[:1])["gpu_cta_step_s"] == 0.0


# ---------------------------------------------------------------------------
# CASPER_TUNE_CACHE, on the plain versions
# ---------------------------------------------------------------------------
def test_measured_autotune_disk_cache_roundtrip(tmp_path, monkeypatch):
    """The counters of ``tests/test_engine.py``'s round trip: the first
    measured tune misses and stores, an identical one is served from disk,
    another configuration misses, and unset the cache is untouched."""
    spec = _port(J_SPECS["jacobi1d"])
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(512)
                         .astype(np.float32))
    monkeypatch.setenv(ttune.TUNE_CACHE_ENV, str(tmp_path))
    ttune.TUNE_DISK_CACHE.reset()
    first = ttune.autotune_measured(spec, g, sweeps=1, top_k=2, reps=1)
    assert ttune.TUNE_DISK_CACHE.as_dict() == {"hits": 0, "misses": 1,
                                               "stores": 1}
    assert first.measured and len(first.table) == 2
    again = ttune.autotune_measured(spec, g, sweeps=1, top_k=2, reps=1)
    assert ttune.TUNE_DISK_CACHE.as_dict() == {"hits": 1, "misses": 1,
                                               "stores": 1}
    assert again.tile == first.tile and again.table == first.table
    ttune.autotune_measured(spec, g, sweeps=2, top_k=2, reps=1)
    assert ttune.TUNE_DISK_CACHE.as_dict() == {"hits": 1, "misses": 2,
                                               "stores": 2}
    monkeypatch.delenv(ttune.TUNE_CACHE_ENV)
    counters = ttune.TUNE_DISK_CACHE.as_dict()
    ttune.autotune_measured(spec, g, sweeps=1, top_k=2, reps=1)
    assert ttune.TUNE_DISK_CACHE.as_dict() == counters


def test_disk_cache_key_separates_device_and_calibration(tmp_path,
                                                        monkeypatch):
    spec = _port(J_SPECS["jacobi2d"])
    args = (spec, (40, 70), 8, 4, "cuda", 3, 2)
    cpu = ttune._tune_cache_key(*args, ttune.device_kind("cpu"))
    assert ttune.device_kind(torch.device("cpu")) == "cpu"
    assert cpu != ttune._tune_cache_key(*args, "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv(tpm.CALIBRATION_ENV, '{"gpu_bw": 2e12}')
    assert cpu != ttune._tune_cache_key(*args, "cpu")
    # a corrupt entry is measured again, not served
    monkeypatch.delenv(tpm.CALIBRATION_ENV)
    monkeypatch.setenv(ttune.TUNE_CACHE_ENV, str(tmp_path))
    (tmp_path / f"{cpu}.json").write_text("{not json")
    ttune.TUNE_DISK_CACHE.reset()
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((40, 70)))
    ttune.autotune_measured(spec, g, sweeps=4, top_k=3, reps=2)
    assert ttune.TUNE_DISK_CACHE.as_dict() == {"hits": 0, "misses": 1,
                                               "stores": 1}


def test_measured_autotune_of_a_pipeline_and_a_batch():
    pipe = _port(J_PIPES["reaction_diffusion2d"])
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 24, 40)))
    res = ttune.autotune_measured(pipe, g, sweeps=2, top_k=2, reps=1)
    analytic = ttune.autotune_pipeline(pipe, (24, 40), sweeps=2, itemsize=8)
    assert {t for t, _ in res.table} == {t for t, _ in analytic.table[:2]}
    timed = ttune.measure_tiles(pipe, g, [res.tile], sweeps=2, rounds=1,
                                strategy="padded-window")
    assert timed[0][0] == res.tile and timed[0][1] > 0


# ---------------------------------------------------------------------------
# tile="auto" through the engine
# ---------------------------------------------------------------------------
AUTO_CASES = [("jacobi1d", "reflect"), ("7pt1d", "periodic"),
              ("blur2d", "constant(0.75)"), ("jacobi2d", "zero"),
              ("heat3d", "periodic"), ("star33_3d", "reflect")]


def _reference(spec, a, iters):
    with jax.enable_x64(True):
        return np.asarray(JEngine(spec, backend="ref").run(jnp.asarray(a),
                                                           iters=iters))


@pytest.mark.parametrize("name,boundary", AUTO_CASES)
def test_engine_auto_tile_bitwise_matches_reference(name, boundary):
    ref = J_SPECS[name].with_boundary(boundary)
    a = np.random.default_rng(11).standard_normal(SHAPES[ref.ndim])
    eng = CasperEngine(_port(ref), backend="cuda", device="cpu", sweeps=4,
                       tile="auto")
    got = eng.run(grid_from_numpy(a), iters=10)
    np.testing.assert_array_equal(got.numpy(), _reference(ref, a, 10))
    plan = eng.plan_for(SHAPES[ref.ndim], torch.float64)
    assert plan.tile_request == "auto"
    assert plan.tile == ttune.autotune(_port(ref), SHAPES[ref.ndim], 4,
                                       8).tile
    assert plan.ghost_strategy == tplan.ghost_strategy_for(
        _port(ref), SHAPES[ref.ndim], 8, 4, plan.tile)


@pytest.mark.parametrize("name", list(J_PIPES) + ["advect_react"])
def test_engine_auto_tile_pipelines_bitwise_match_reference(name):
    from repro.core import StencilPipeline as JPipeline
    if name == "advect_react":      # mixes periodic with zero: staged
        ref = JPipeline("advect_react", (
            J_PIPES["advect_diffuse2d"].stages[0],
            J_PIPES["reaction_diffusion2d"].stages[1]))
    else:
        ref = J_PIPES[name]
    a = np.random.default_rng(12).standard_normal((24, 40))
    eng = CasperEngine(_port(ref), backend="cuda", device="cpu", sweeps=4,
                       tile="auto")
    got = eng.run(a, iters=10)
    np.testing.assert_array_equal(got.numpy(), _reference(ref, a, 10))


def test_second_identical_auto_engine_lowers_and_tunes_nothing():
    spec = _port(J_SPECS["blur2d"].with_boundary("reflect"))
    a = np.random.default_rng(13).standard_normal((40, 70))
    tplan.PLAN_CACHE.clear()
    CasperEngine(spec, backend="cuda", device="cpu", sweeps=4,
                 tile="auto").run(a, iters=10)
    first = tplan.plan_cache_stats()
    # the block of 4 and the remainder of 2: one plan and one tune each
    assert first["lowers"] == 2 and first["autotune_calls"] == 2
    runner_before = tplan.runner_cache_stats()["runner"]
    CasperEngine(spec, backend="cuda", device="cpu", sweeps=4,
                 tile="auto").run(a, iters=10)
    again = tplan.plan_cache_stats()
    assert again["lowers"] == 2 and again["autotune_calls"] == 2
    assert tplan.runner_cache_stats()["runner"]["hits"] \
        == runner_before["hits"] + 1
    # the default tile lowers its own plans and tunes nothing
    CasperEngine(spec, backend="cuda", device="cpu", sweeps=4).run(a, 10)
    assert tplan.plan_cache_stats()["autotune_calls"] == 2


def test_auto_tile_is_resolved_at_lowering_only():
    spec = _port(J_SPECS["jacobi2d"])
    with pytest.raises(ValueError, match="resolved by plan.lower"):
        tplan.normalize_tile(spec, "auto", 4, 8, (40, 70))
    plan = tplan.lower(spec, (40, 70), torch.float64, backend="cuda",
                       sweeps=4, tile="auto", device="cpu")
    assert plan.tile == ttune.autotune(spec, (40, 70), 4, 8).tile
    # the oracle backend has no kernel tile to tune
    assert tplan.lower(spec, (40, 70), torch.float64, backend="ref",
                       tile="auto", device="cpu").tile is None


# ---------------------------------------------------------------------------
# Item 15: the kernels package's leftovers, vs repro
# ---------------------------------------------------------------------------
def test_runner_cache_stats_matches_reference_shape():
    got = tplan.runner_cache_stats()
    want = jplan.runner_cache_stats()
    assert set(got["runner"]) == set(want["runner"])
    assert got["autotune_calls"] == tplan.plan_cache_stats()[
        "autotune_calls"]


@pytest.mark.parametrize("name,boundary,iters,sweeps,tile", [
    ("jacobi1d", "periodic", 7, 2, (64,)),
    ("blur2d", "reflect", 5, 2, (8, 32)),
    ("heat3d", "zero", 3, 2, None),
])
def test_run_sweeps_matches_reference(name, boundary, iters, sweeps, tile):
    ref = J_SPECS[name].with_boundary(boundary)
    shape = {1: (97,), 2: (19, 40), 3: (6, 9, 20)}[ref.ndim]
    a = np.random.default_rng(14).standard_normal(shape)
    got = teng.run_sweeps(_port(ref), grid_from_numpy(a), iters, tile=tile,
                          sweeps=sweeps)
    with jax.enable_x64(True):
        want = jeng.run_sweeps(ref, jnp.asarray(a), iters, tile=tile,
                               sweeps=sweeps, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tkernels.run_sweeps is teng.run_sweeps


@pytest.mark.parametrize("rank,name", [(1, "7pt1d"), (2, "blur2d"),
                                       (3, "heat3d")])
def test_deprecated_rank_shims_warn_and_match_reference(rank, name):
    ref = J_SPECS[name].with_boundary("reflect")
    shape = {1: (77,), 2: (20, 45), 3: (5, 9, 20)}[rank]
    a = np.random.default_rng(15).standard_normal(shape)
    with pytest.warns(DeprecationWarning, match=f"stencil{rank}d"):
        got = getattr(tkernels, f"stencil{rank}d")(_port(ref),
                                                   grid_from_numpy(a))
    with jax.enable_x64(True), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = getattr(jkernels, f"stencil{rank}d")(ref, jnp.asarray(a),
                                                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alias", ["stencil_ref", "swa_ref", "StencilSpec"])
def test_kernels_ref_aliases_warn_and_resolve(alias):
    from repro_torch.core import ref as core_ref
    from repro_torch.core import stencil as core_stencil
    from repro_torch.kernels import swa as tswa
    target = {"stencil_ref": core_ref.apply_stencil, "swa_ref": tswa.swa_ref,
              "StencilSpec": core_stencil.StencilSpec}[alias]
    with pytest.warns(DeprecationWarning, match=f"kernels.ref.{alias}"):
        assert getattr(tkernels.ref, alias) is target
    assert alias in dir(tkernels.ref)
    with pytest.raises(AttributeError):
        tkernels.ref.nothing_here


def test_kernels_ref_stencil_ref_matches_reference():
    ref = J_SPECS["blur2d"].with_boundary("periodic")
    a = np.random.default_rng(16).standard_normal((12, 17))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = tkernels.ref.stencil_ref(_port(ref), torch.from_numpy(a))
        with jax.enable_x64(True):
            want = jkernels.ref.stencil_ref(ref, jnp.asarray(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", list(J_SPECS))
def test_numpy_oracles_match_reference(name, boundary):
    ref = J_SPECS[name].with_boundary(boundary)
    shape = {1: (23,), 2: (9, 13), 3: (5, 6, 7)}[ref.ndim]
    a = np.random.default_rng(17).standard_normal(shape)
    port = _port(ref)
    np.testing.assert_array_equal(tref.apply_stencil_numpy(port, a),
                                  jref.apply_stencil_numpy(ref, a))
    np.testing.assert_array_equal(tref.apply_stencil_numpy(port, a),
                                  tref.apply_stencil(port,
                                                     torch.from_numpy(a))
                                  .numpy())
    np.testing.assert_array_equal(tref.apply_stencil_loops(port, a),
                                  jref.apply_stencil_loops(ref, a))
    widths = tuple(2 * h + 1 for h in ref.halo)
    mode, value = port.boundary_mode, port.boundary_value
    np.testing.assert_array_equal(
        tref.pad_boundary_numpy(a, widths, mode, value),
        jref.pad_boundary_numpy(a, widths, mode, value))


def test_tap_sum_numpy_matches_reference():
    rng = np.random.default_rng(18)
    wins = [rng.standard_normal((4, 5)) for _ in range(5)]
    coeffs = rng.standard_normal(5).tolist()
    np.testing.assert_array_equal(tref.tap_sum_numpy(wins, coeffs,
                                                     np.float64),
                                  jref.tap_sum_numpy(wins, coeffs,
                                                     np.float64))
    np.testing.assert_array_equal(
        tref.tap_sum_numpy(wins, coeffs, np.float64),
        tref.tap_sum([torch.from_numpy(w) for w in wins], coeffs,
                     torch.float64).numpy())
