"""The port's static plan verifier and launch lint vs ``repro.analysis``.

* The clean matrix (every paper stencil x 4 boundaries x auto/dense
  structure x sweeps {1, 2}, every paper pipeline as written and rebased
  all-periodic / all-zero, on ``ref``, ``cuda`` and ``vm`` lowered for
  ``device="cpu"``, and the streamed cases of
  ``repro_torch.analysis.casper_lint``) gives no error and no warning;
  ``python -m repro_torch.analysis.casper_lint --device cpu`` exits 0.
* Mutation testing: each corruption of the reference's
  ``tests/test_analysis.py`` corpus, seeded with ``dataclasses.replace``
  on the port's plan, is flagged by the counterpart check, and the same
  corruption of ``repro``'s plan by ``repro``'s check of that name
  (``"vmem-budget"`` for the port's ``"smem-budget"``); then the
  corruptions only the port's rules catch (a periodic grid off K1, a
  small grid off the padded window, an in-core grid streamed, an
  unfitted tile, a non-canonical device, a budget on a ``vm`` plan) and
  the launch lint's (a narrowed f64 instance or accumulator, a build
  without ``-fmad=false``, fusion that saves no bytes).
* Wiring: a second identical ``lower`` runs no analysis; strict mode
  raises and keeps the plan out of the cache; warn warns; off skips;
  ``CASPER_VERIFY`` resolution; ``CasperEngine.analyze``; the launch
  prediction; and ``check_serve_config`` against the reference's
  findings on the same configs.

JAX f64 is scoped with ``jax.enable_x64(True)``.
"""
import dataclasses
import os
import types
import warnings

import pytest
import jax
import jax.numpy as jnp
import torch

from repro import analysis as janalysis
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import plan as jplan
from repro.core.stencil import factor_taps as j_factor_taps
from repro_torch import CasperEngine, PAPER_PIPELINES, PAPER_STENCILS
from repro_torch import analysis
from repro_torch import sharding as tsharding
from repro_torch.analysis import casper_lint, launch_lint, verify
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core.stencil import factor_taps

SHAPES = casper_lint.SHAPES
BOUNDARIES = casper_lint.BOUNDARIES


def lower(spec, backend="cuda", sweeps=2, shape=None, **kw):
    return tplan.lower(spec, shape or SHAPES[spec.ndim], torch.float64,
                       backend=backend, sweeps=sweeps, device="cpu", **kw)


def jlower(spec, backend="pallas", sweeps=2):
    with jax.enable_x64(True):
        return jplan.lower(spec, SHAPES[spec.ndim], jnp.float64,
                           backend=backend, sweeps=sweeps)


def report_of(plan):
    return analysis.report_for(plan) or analysis.verify_plan(plan)


def assert_clean(plan):
    rep = report_of(plan)
    assert not rep.errors, rep.pretty()
    assert not rep.warnings, rep.pretty()


# ---------------------------------------------------------------------------
# The clean matrix: no false positive
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ("ref", "cuda", "vm"))
@pytest.mark.parametrize("name", sorted(PAPER_STENCILS))
def test_clean_stencil_matrix(name, backend):
    for boundary in BOUNDARIES:
        for structure in ("auto", "dense"):
            spec = PAPER_STENCILS[name].with_boundary(boundary)
            spec = spec.with_structure(structure)
            for sweeps in casper_lint.SWEEPS:
                assert_clean(lower(spec, backend, sweeps))


@pytest.mark.parametrize("backend", ("ref", "cuda", "vm"))
def test_clean_pipelines_and_rebased_variants(backend):
    variants = list(casper_lint.pipeline_variants(fast=False))
    assert len(variants) == 3 * len(PAPER_PIPELINES)
    for _, _, pipe in variants:
        for sweeps in casper_lint.SWEEPS:
            plan = lower(pipe, backend, sweeps, shape=(64, 128))
            assert_clean(plan)
            if not plan.fused and backend != "vm":
                for k in range(len(plan.stages)):
                    assert_clean(plan.stage_plan(k))


def test_clean_streamed_cases():
    n = 0
    for _, spec, shape, backend, sweeps, budget in casper_lint.iter_slab_cases(
            fast=False):
        plan = casper_lint.lower_case(spec, shape, backend, sweeps, budget,
                                      "cpu")
        assert plan.streams_from_host, (spec.name, backend)
        assert_clean(plan)
        n += 1
    assert n == 4 * 2 * 2 + 2 * len(PAPER_PIPELINES)


def test_casper_lint_cli_exits_zero(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert casper_lint.main(["--device", "cpu", "--strict", "--out",
                             str(out)]) == 0
    analysis.set_verify_mode(None)
    import json
    payload = json.loads(out.read_text())
    assert payload["n_errors"] == 0 and payload["n_warnings"] == 0
    assert payload["n_plans"] == len(casper_lint.all_cases(False))
    assert "0 errors" in capsys.readouterr().out


def test_engine_analyze_every_paper_stencil_and_pipeline():
    for spec in list(PAPER_STENCILS.values()) + list(PAPER_PIPELINES.values()):
        eng = CasperEngine(spec, backend="cuda", device="cpu", sweeps=2)
        rep = eng.analyze(SHAPES[spec.ndim], torch.float64)
        assert isinstance(rep, analysis.Report)
        assert rep.ok, rep.pretty()
        assert set(verify.CHECKS) <= set(rep.checks_run)
        assert set(launch_lint.LINT_CHECKS) <= set(rep.checks_run)
    d = CasperEngine(PAPER_STENCILS["blur2d"], device="cpu").analyze(
        (24, 40)).as_dict()
    assert d["ok"] and d["plan"].startswith("blur2d@(24, 40) float32")


def test_only_mesh_is_left_unported():
    # the mesh was the last refusal, and it is accepted now: the port has
    # no unported path left, and its verifier runs every reference check
    # ("distributed" too)
    assert not hasattr(tplan, "_NOT_PORTED")
    assert not hasattr(tsharding, "SHARDED_SLICE")
    mesh = tsharding.MeshShape((2, 2), ("data", "model"))
    assert tsharding.ShardCtx(mesh=mesh).pspec("fsdp") == tsharding.P("data")
    assert "distributed" in verify.CHECKS
    # the counterparts keep the reference's names, vmem -> smem
    ref_names = set(janalysis.CHECKS) - {"vmem-budget"}
    assert set(verify.CHECKS) == ref_names | {"smem-budget"}


# ---------------------------------------------------------------------------
# Mutation testing: the reference's corpus on both packages
# ---------------------------------------------------------------------------
def _errors_of(check_fn, mutant):
    return {f.check for f in check_fn(mutant).errors}


def _port_clean():
    return lower(PAPER_STENCILS["blur2d"])


def _ref_clean():
    return jlower(J_SPECS["blur2d"])


def _streamed(lower_fn, spec, env):
    budget = 64 * 128 * 8 // 4
    old = os.environ.get(env)
    os.environ[env] = str(budget)
    try:
        plan = lower_fn(spec)
    finally:
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old
    assert plan.streams_from_host
    return plan


def _port_streamed():
    return _streamed(lambda s: lower(s, "ref"), PAPER_STENCILS["jacobi2d"],
                     tpm.SLAB_BUDGET_ENV)


def _ref_streamed():
    from repro.core import perfmodel as jpm
    return _streamed(lambda s: jlower(s, "ref"), J_SPECS["jacobi2d"],
                     jpm.SLAB_BUDGET_ENV)


def _slabs(plan, k, start_shift):
    slabs = list(plan.slabs)
    s0, s1 = slabs[k]
    slabs[k] = (s0 + start_shift, s1)
    return tuple(slabs)


# (case, port check, reference check, clean plan kind, mutation(plan, ft))
# where ft is the package's factor_taps
MUTATIONS = [
    ("deep-halo", "halo-arithmetic", "halo-arithmetic", "clean",
     lambda p, ft: dataclasses.replace(
         p, deep_halo=tuple(h + 1 for h in p.deep_halo))),
    ("halo", "halo-arithmetic", "halo-arithmetic", "clean",
     lambda p, ft: dataclasses.replace(p, halo=tuple(h + 1 for h in p.halo))),
    ("strategy-pad", "ghost-strategy", "ghost-strategy", "clean",
     lambda p, ft: dataclasses.replace(p, ghost_strategy="pad")),
    ("strategy-bogus", "ghost-strategy", "ghost-strategy", "clean",
     lambda p, ft: dataclasses.replace(p, ghost_strategy="bogus")),
    ("oversized-tile", "smem-budget", "vmem-budget", "clean",
     lambda p, ft: dataclasses.replace(p, tile=(2048, 2048))),
    ("dense-factorization", "factorization", "factorization", "clean",
     lambda p, ft: dataclasses.replace(
         p, factorization=ft(p.spec.with_structure("dense")))),
    ("no-factorization", "factorization", "factorization", "clean",
     lambda p, ft: dataclasses.replace(p, factorization=None)),
    ("broken-decompose", "decompose", "decompose", "clean",
     lambda p, ft: dataclasses.replace(p, sweeps=0)),
    ("noncanonical-dtype", "plan-fields", "plan-fields", "clean",
     lambda p, ft: dataclasses.replace(p, dtype="double")),
    ("fused-flag", "fusability", "fusability", "clean",
     lambda p, ft: dataclasses.replace(p, fused=False,
                                       ghost_strategy="staged", tile=None)),
    ("slab-gap", "slabs", "slabs", "streamed",
     lambda p, ft: dataclasses.replace(p, slabs=_slabs(p, 1, 1))),
    ("slab-overlap", "slabs", "slabs", "streamed",
     lambda p, ft: dataclasses.replace(p, slabs=_slabs(p, 1, -1))),
    ("slab-cover-short", "slabs", "slabs", "streamed",
     lambda p, ft: dataclasses.replace(p, slabs=p.slabs[:-1])),
    ("shallow-overlap", "slabs", "slabs", "streamed",
     lambda p, ft: dataclasses.replace(p, slab_overlap=p.slab_overlap - 1)),
    ("slab-over-budget", "slabs", "slabs", "streamed",
     lambda p, ft: dataclasses.replace(p, slabs=((0, p.shape[0]),))),
    ("in-core-carrying-slabs", "slabs", "slabs", "in-core-ref",
     lambda p, ft: dataclasses.replace(p, slabs=((0, 64),))),
    ("in-core-carrying-overlap", "slabs", "slabs", "in-core-ref",
     lambda p, ft: dataclasses.replace(p, slab_overlap=2)),
]


@pytest.mark.parametrize("case,check,jcheck,kind,mutate", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_mutation_flagged_by_both_packages(case, check, jcheck, kind,
                                           mutate):
    port = {"clean": _port_clean, "streamed": _port_streamed,
            "in-core-ref": lambda: lower(PAPER_STENCILS["jacobi2d"], "ref")}
    ref = {"clean": _ref_clean, "streamed": _ref_streamed,
           "in-core-ref": lambda: jlower(J_SPECS["jacobi2d"], "ref")}
    clean = port[kind]()
    assert not analysis.verify_plan(clean).errors
    assert check in _errors_of(analysis.verify_plan,
                               mutate(clean, factor_taps))
    with jax.enable_x64(True):
        jclean = ref[kind]()
        assert not janalysis.verify_plan(jclean).errors
        assert jcheck in _errors_of(janalysis.verify_plan,
                                    mutate(jclean, j_factor_taps))


def _port_only(plan, check, **changes):
    assert not analysis.verify_plan(plan).errors
    return check in _errors_of(analysis.verify_plan,
                               dataclasses.replace(plan, **changes))


def test_port_rule_every_periodic_grid_is_pad_free():
    # the reference sends a periodic grid past an L2 budget to the padded
    # window; the port's K1 takes every periodic grid
    plan = lower(PAPER_STENCILS["jacobi2d"].with_boundary("periodic"),
                 shape=(32, 64))
    assert plan.ghost_strategy == "pad-free"
    assert _port_only(plan, "ghost-strategy", ghost_strategy="padded-window")


def test_port_rule_small_grids_take_the_padded_window():
    plan = lower(PAPER_STENCILS["jacobi2d"], sweeps=4, shape=(32, 64))
    assert plan.ghost_strategy == "padded-window"
    assert plan.tile == (32, 64)          # fitted to the grid
    flagged = _errors_of(analysis.verify_plan, dataclasses.replace(
        plan, ghost_strategy="pad-free"))
    assert {"ghost-strategy", "tile-legality"} <= flagged


def test_port_rule_in_core_grid_must_not_stream():
    plan = lower(PAPER_STENCILS["jacobi2d"], "ref")
    slabs = ((0, 32), (32, 64))
    assert _port_only(plan, "ghost-strategy", ghost_strategy="stream-from-host",
                      slabs=slabs, slab_overlap=plan.deep_halo[0])


def test_port_rule_vm_streams_and_records_no_budget():
    plan = lower(PAPER_STENCILS["heat3d"], "vm")
    assert plan.ghost_strategy == "stream" and plan.slab_budget is None
    assert _port_only(plan, "ghost-strategy", ghost_strategy="pad")
    assert _port_only(plan, "plan-fields", slab_budget=10 ** 9)
    assert _port_only(lower(PAPER_STENCILS["heat3d"], "ref"), "plan-fields",
                      slab_budget=None)


def test_port_rule_tile_fitted_to_the_grid():
    plan = lower(PAPER_STENCILS["jacobi2d"], sweeps=4, shape=(32, 64))
    assert _port_only(plan, "tile-legality", tile=(64, 64))
    assert _port_only(plan, "tile-legality", tile=None)
    assert _port_only(lower(PAPER_STENCILS["jacobi2d"], "ref"),
                      "tile-legality", tile=(8, 32))
    auto = lower(PAPER_STENCILS["jacobi2d"], sweeps=4, shape=(32, 64),
                 tile="auto")
    assert not analysis.verify_plan(auto).errors
    assert _port_only(auto, "tile-legality", tile=(64, 64))


def test_port_rule_streamed_cuda_plan_carries_its_slab_tile():
    plan = _streamed(lambda s: lower(s, "cuda"), PAPER_STENCILS["jacobi2d"],
                     tpm.SLAB_BUDGET_ENV)
    rows = plan.slabs[0][1] - plan.slabs[0][0]
    assert plan.tile[0] <= rows
    assert not analysis.verify_plan(plan).errors


def test_port_rule_device_and_dtype_names():
    plan = _port_clean()
    assert _port_only(plan, "plan-fields", device="gpu")
    assert _port_only(plan, "plan-fields", dtype="torch.float64")
    assert _port_only(plan, "plan-fields", backend="pallas")


def test_program_mismatch_flagged():
    plan = _port_clean()
    other = lower(PAPER_STENCILS["jacobi2d"]).program
    assert _port_only(plan, "program", program=other)


def test_check_that_raises_is_reported_not_raised():
    plan = dataclasses.replace(_port_clean(), spec=None)
    rep = analysis.verify_plan(plan)
    assert not rep.ok
    assert any("check raised" in f.message for f in rep.errors)


# ---------------------------------------------------------------------------
# The launch lint
# ---------------------------------------------------------------------------
def test_lint_dtype_contract_mutations():
    plan = _port_clean()
    assert not launch_lint.lint_dtype(plan)
    narrowed = {torch.float64: "casper_stencil_f32"}
    found = launch_lint.lint_dtype(plan, entry=narrowed)
    assert found and found[0].check == "dtype-contract"
    found = launch_lint.lint_dtype(plan, acc_dtype=lambda d: torch.float32)
    assert found and "float64 -> torch.float32" in found[0].message
    assert launch_lint.lint_dtype(plan, entry={})[0].severity == "error"
    assert not launch_lint.lint_dtype(lower(PAPER_STENCILS["blur2d"], "ref"))


def test_lint_fma_contraction():
    plan = _port_clean()
    assert not launch_lint.lint_fma_contraction(plan)
    from repro_torch.kernels import _build
    flags = tuple(f for f in _build.NVCC_FLAGS if f != "-fmad=false")
    found = launch_lint.lint_fma_contraction(plan, flags)
    assert found and found[0].check == "fma-contraction"


def test_lint_hbm_roundtrips():
    plan = lower(PAPER_PIPELINES["reaction_diffusion2d"], sweeps=1)
    assert plan.fused and plan.boundary_mode != "periodic"
    assert not launch_lint.lint_hbm(plan)
    fake = {"fused_bytes": 2.0, "staged_bytes": 2.0}
    found = launch_lint.lint_hbm(plan, traffic=fake)
    assert found and found[0].check == "hbm-roundtrips"
    rep = launch_lint.lint_plan(plan)
    assert rep.ok and rep.checks_run == launch_lint.LINT_CHECKS


def test_lint_skips_vm_and_reports_launches():
    rep = launch_lint.lint_plan(lower(PAPER_STENCILS["jacobi1d"], "vm"))
    assert rep.ok and [f.check for f in rep.infos] == ["launch-lint"]
    rep = launch_lint.lint_plan(_port_streamed())
    assert rep.ok
    rep = launch_lint.lint_plan(_port_clean())
    assert any(f.check == "launches" and "'K2': 1" in f.message
               for f in rep.infos)
    bad = dataclasses.replace(_port_clean(), ghost_strategy="pad")
    assert launch_lint.lint_launches(bad)[0].severity == "error"


# ---------------------------------------------------------------------------
# Distributed plans, on a one-rank gloo mesh in a spawned process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def single_rank(tmp_path_factory):
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "_dist_world", os.path.join(here, "_dist_world.py"))
    world = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(world)
    return world.run_world("single", 1,
                           str(tmp_path_factory.mktemp("single_rank")),
                           timeout=120)[0]["checks"]


def test_mutation_wrong_exchange_strategy(single_rank):
    """A clean distributed plan (jacobi2d periodic, wrap ring) verifies;
    a wrong exchange strategy, a shard shape that does not reproduce the
    grid, a dishonest fingerprint, an exchange on an unsharded dim or on
    a staged chain, and distributed fields on a single-device plan fail
    the ``"distributed"`` check; padding it pad-free fails
    ``"ghost-strategy"`` and a budget ``"plan-fields"``."""
    assert single_rank["verify/clean"][0], single_rank["verify/clean"]
    for name in ("wrong_exchange", "fingerprint", "unsharded_exchange",
                 "staged_exchange", "single_with_fields"):
        assert single_rank[f"mutant/{name}"][1] == ["distributed"], name
    assert "distributed" in single_rank["mutant/shard_shape"][1]
    assert single_rank["mutant/pad_free"][1] == ["ghost-strategy"]
    assert single_rank["mutant/budget"][1] == ["plan-fields"]


def test_lint_predicts_distributed_launches_and_rounds(single_rank):
    """The reference's lint skips a distributed plan; the port's predicts
    per rank one K2 per fused step and the exchange rounds of each, and
    the prediction equals the rounds the run counted."""
    assert single_rank["lint/prediction"][0], single_rank["lint/prediction"]


def test_predicted_launches():
    blur = lower(PAPER_STENCILS["blur2d"], sweeps=4, shape=(128, 256))
    assert blur.ghost_strategy == "pad-free"                      # K1
    assert launch_lint.predicted_launches(blur) == {"K1": 1}
    assert launch_lint.predicted_launches(blur, 10, batch=5) == {"K1": 3}
    assert launch_lint.predicted_launches(blur, 0) == {}
    small = lower(PAPER_STENCILS["jacobi2d"], sweeps=4, shape=(32, 64))
    assert launch_lint.predicted_launches(small, 8, batch=48) == {"K2": 2}
    rd = lower(PAPER_PIPELINES["reaction_diffusion2d"], sweeps=4,
               shape=(32, 64))
    assert launch_lint.predicted_launches(rd, 8) == {"K4": 2}
    staged = PAPER_PIPELINES["reaction_diffusion2d"].with_boundary("reflect")
    mixed = dataclasses.replace(staged, stages=(
        PAPER_STENCILS["jacobi2d"].with_boundary("periodic"),
        PAPER_STENCILS["jacobi2d"]))
    plan = lower(mixed, sweeps=4, shape=(64, 128))
    assert not plan.fused
    assert launch_lint.predicted_launches(plan, 5) == {"K1": 5, "K2": 5}
    streamed = _streamed(lambda s: lower(s, "cuda", sweeps=2),
                         PAPER_STENCILS["jacobi2d"], tpm.SLAB_BUDGET_ENV)
    n = len(streamed.slabs)
    assert launch_lint.predicted_launches(streamed, 4, batch=3) == {
        "K2": 2 * n * 3}
    assert launch_lint.predicted_launches(lower(PAPER_STENCILS["jacobi2d"],
                                                "ref"), 4) == {}


# ---------------------------------------------------------------------------
# Wiring: the lowering hook, the report cache, the modes
# ---------------------------------------------------------------------------
def _unique_spec(tag):
    return dataclasses.replace(PAPER_STENCILS["jacobi2d"],
                               name=f"torch_analysis_{tag}")


def test_second_identical_lower_runs_no_analysis():
    spec = _unique_spec("cache")
    analysis.clear_reports()
    p1 = lower(spec)
    assert analysis.counters()["verifications"] == 1
    p2 = lower(spec)
    assert p1 is p2
    assert analysis.counters()["verifications"] == 1
    rep = analysis.report_for(p1)
    assert rep is not None and rep.ok
    assert analysis.analyze_plan(p1, lint=False) is rep
    assert analysis.counters()["report_cache_hits"] == 1


def test_strict_mode_raises_and_does_not_cache(monkeypatch):
    spec = _unique_spec("strict")
    monkeypatch.setitem(verify.CHECKS, "always-bad", lambda plan: [
        verify.Finding("always-bad", "error", "seeded")])
    analysis.set_verify_mode("strict")
    try:
        n = len(tplan.PLAN_CACHE.keys())
        with pytest.raises(analysis.PlanVerificationError) as ei:
            lower(spec)
        assert "always-bad" in str(ei.value) and ei.value.report.errors
        assert len(tplan.PLAN_CACHE.keys()) == n
        with pytest.raises(analysis.PlanVerificationError):
            lower(spec)
    finally:
        analysis.set_verify_mode(None)


def test_strict_env_verifies_instead_of_refusing(monkeypatch):
    monkeypatch.setenv(analysis.VERIFY_ENV, "strict")
    plan = lower(_unique_spec("strict_env"))
    assert analysis.report_for(plan).ok
    assert CasperEngine(plan.spec, backend="cuda", device="cpu",
                        sweeps=2).run(torch.ones(64, 128), 3).shape == (64, 128)


def test_warn_mode_warns(monkeypatch):
    monkeypatch.setitem(verify.CHECKS, "always-bad", lambda plan: [
        verify.Finding("always-bad", "error", "seeded")])
    analysis.set_verify_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            plan = lower(_unique_spec("warn"))
    finally:
        analysis.set_verify_mode(None)
    msgs = [x for x in w
            if issubclass(x.category, analysis.PlanVerificationWarning)]
    assert msgs and "always-bad" in str(msgs[0].message)
    assert plan is not None


def test_off_mode_skips():
    analysis.clear_reports()
    analysis.set_verify_mode("off")
    try:
        plan = lower(_unique_spec("off"))
        assert analysis.counters()["verifications"] == 0
        assert analysis.report_for(plan) is None
    finally:
        analysis.set_verify_mode(None)


def test_verify_mode_resolution(monkeypatch):
    monkeypatch.setenv(analysis.VERIFY_ENV, "strict")
    assert analysis.verify_mode() == "strict"
    analysis.set_verify_mode("off")
    try:
        assert analysis.verify_mode() == "off"
    finally:
        analysis.set_verify_mode(None)
    monkeypatch.setenv(analysis.VERIFY_ENV, "bogus")
    with pytest.raises(ValueError):
        analysis.verify_mode()
    with pytest.raises(ValueError):
        analysis.set_verify_mode("loud")


# ---------------------------------------------------------------------------
# Serving config checks vs the reference's
# ---------------------------------------------------------------------------
def _config(**kw):
    fields = dict(max_bucket_size=32, max_wait_s=0.005, queue_depth=1024,
                  default_deadline_s=None, shed_policy="reject")
    fields.update(kw)
    return types.SimpleNamespace(**fields)


SERVE_CONFIGS = [
    {}, {"max_bucket_size": 0}, {"max_wait_s": -1.0},
    {"max_bucket_size": 8, "queue_depth": 4}, {"default_deadline_s": 0.0},
    {"shed_policy": "drop-oldest"},
    {"max_wait_s": 1.0, "default_deadline_s": 0.5},
    {"max_bucket_size": 2, "max_wait_s": 1.0},
    {"max_bucket_size": 1, "max_wait_s": 0.0},
    {"max_bucket_size": 2, "max_wait_s": 0.5, "default_deadline_s": 0.01},
]


@pytest.mark.parametrize("kw", SERVE_CONFIGS, ids=str)
def test_check_serve_config_matches_reference(kw):
    cfg = _config(**kw)
    got = analysis.check_serve_config(cfg)
    want = janalysis.check_serve_config(cfg)
    assert [(f.check, f.severity) for f in got] == \
        [(f.check, f.severity) for f in want]
    # every message but the dispatch constant's is the reference's own
    for g, w in zip(got, want):
        if "per-dispatch overhead" not in w.message:
            assert g.message == w.message
    assert analysis.SHED_POLICIES == janalysis.SHED_POLICIES


def test_dispatch_warning_reads_the_measured_constant():
    """The bucket-cap warning's threshold is 100x the card's measured
    dispatch overhead, not the reference's CPU-host 150e-6."""
    from repro.core import perfmodel as jpm
    assert tpm.SERVE_DISPATCH_OVERHEAD_S != jpm.SERVE_DISPATCH_OVERHEAD_S
    edge = 100 * tpm.SERVE_DISPATCH_OVERHEAD_S
    assert not analysis.check_serve_config(_config(max_bucket_size=2,
                                                   max_wait_s=edge))
    found = analysis.check_serve_config(_config(max_bucket_size=2,
                                                max_wait_s=edge * 1.01))
    assert [f.severity for f in found] == ["warning"]
    assert "measured per-dispatch overhead" in found[0].message
