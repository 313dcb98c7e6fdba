"""The port's batched stencil serving vs ``repro.serve``.

``repro.serve`` imports ``jax.experimental.enable_x64``, which jax 0.9
no longer has; the ``jserve`` fixture (``tests/_serve_reference.py``)
aliases it to ``jax.enable_x64`` for this module's tests only and then
restores the import state, so the reference's own serving tests see the
package exactly as before.  Every reference call runs under
``with jax.enable_x64(True):``.

* ``StencilServer.serve`` and ``serve_sequential`` (``ref`` and ``cuda``
  on ``device="cpu"``: the kernels' plain versions) on
  ``mixed_requests(64, seed=7, float64)`` and on pipeline requests are
  bitwise equal to ``repro``'s ``serve_sequential``;
* the load generator draws the reference's multiset and schedule;
* bucket stats, rejections and the clock-tick clamp match the
  reference's;
* the port's own paths: ``BatchHandle`` per bucket, a bucket
  past a forced budget (in slabs, or in parts), results as CPU tensors,
  ``device=None`` meaning CUDA, ``request_from_reference`` and
  ``serve_config_from_reference``.
"""
import numpy as np
import pytest
import jax
import torch

from repro_torch import request_from_reference, serve_config_from_reference
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.serve import (StencilRequest, StencilServer, loadgen,
                               mixed_requests)
from repro_torch.serve import stencil as tstencil

from _serve_reference import jserve, reference_sequential  # noqa: F401


def equal(got, want) -> bool:
    return (isinstance(got, torch.Tensor) and got.device.type == "cpu"
            and got.dtype == torch.float64
            and np.array_equal(got.numpy(), want))


def pipeline_requests(rng):
    g = lambda shape: rng.standard_normal(shape)
    return [
        StencilRequest("reaction_diffusion2d", g((16, 24)), 4),
        StencilRequest("jacobi2d", g((16, 24)), 4),
        StencilRequest("reaction_diffusion2d", g((16, 24)), 4),
        StencilRequest("advect_diffuse2d", g((16, 32)), 3),
        StencilRequest("reaction_diffusion2d", g((16, 24)), 6),
        StencilRequest("advect_diffuse2d", g((16, 32)), 0),
    ]


@pytest.mark.parametrize("backend", ("ref", "cuda"))
@pytest.mark.parametrize("sweeps", (1, 4))
def test_mix_bitwise_vs_reference_sequential(jserve, backend, sweeps):
    reqs = mixed_requests(64, seed=7, dtype=np.float64)
    jreqs = jserve.mixed_requests(64, seed=7, dtype=np.float64)
    want = reference_sequential(jserve, jreqs, sweeps)
    srv = StencilServer(backend=backend, sweeps=sweeps, device="cpu")
    for serve in (srv.serve, srv.serve_sequential):
        got, stats = serve(reqs)
        assert stats.n_requests == 64 and stats.n_rejected == 0
        assert all(equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("backend", ("ref", "cuda"))
def test_pipeline_requests_bitwise_vs_reference(jserve, backend, rng):
    reqs = pipeline_requests(rng)
    jreqs = [jserve.StencilRequest(r.spec_name, r.grid, r.iters)
             for r in reqs]
    want = reference_sequential(jserve, jreqs, 2)
    srv = StencilServer(backend=backend, sweeps=2, device="cpu")
    got, stats = srv.serve(reqs)
    assert all(equal(g, w) for g, w in zip(got, want))
    assert stats.n_buckets == 5
    assert sorted((b["iters"], b["size"]) for b in stats.buckets
                  if b["spec"] == "reaction_diffusion2d") == [(4, 2), (6, 1)]


def test_loadgen_draws_the_reference_multiset(jserve):
    for n, seed in ((64, 7), (24, 11), (5, 0)):
        mine = mixed_requests(n, seed=seed, dtype=np.float64)
        ref = jserve.mixed_requests(n, seed=seed, dtype=np.float64)
        assert [(r.spec_name, r.iters) for r in mine] == \
            [(r.spec_name, r.iters) for r in ref]
        assert all(np.array_equal(a.grid, b.grid) for a, b in zip(mine, ref))
    from repro.serve import loadgen as jloadgen
    assert np.array_equal(loadgen.poisson_times(50, 600.0, seed=5),
                          jloadgen.poisson_times(50, 600.0, seed=5))
    with pytest.raises(ValueError):
        loadgen.poisson_times(3, 0.0)
    reqs = mixed_requests(8, seed=1)
    work = loadgen.poisson_workload(reqs, 100.0, seed=2)
    assert [w.request for w in work] == reqs
    assert [w.at_s for w in work] == [w.at_s for w in jloadgen.poisson_workload(
        reqs, 100.0, seed=2)]


def test_bucket_stats_match_reference(jserve, rng):
    reqs = pipeline_requests(rng) + mixed_requests(24, seed=3,
                                                   dtype=np.float64)
    jreqs = [jserve.StencilRequest(r.spec_name, r.grid, r.iters)
             for r in reqs]

    def identities(stats):
        return [(b["spec"], tuple(b["shape"]), b["dtype"], b["iters"],
                 b["size"]) for b in stats.buckets]

    _, st = StencilServer(backend="cuda", sweeps=2,
                          device="cpu").serve(reqs)
    with jax.enable_x64(True):
        _, jst = jserve.StencilServer(backend="ref", sweeps=2).serve(jreqs)
    assert identities(st) == identities(jst)
    assert identities(st) == sorted(identities(st))
    _, st2 = StencilServer(backend="cuda", sweeps=2, device="cpu").serve(
        list(reversed(reqs)))
    assert identities(st2) == identities(st)
    assert st.n_buckets == jst.n_buckets
    assert not any(b["slab_streamed"] for b in st.buckets)


def test_rejections_match_reference(jserve, rng):
    good = rng.standard_normal((12, 16))
    reqs = [
        StencilRequest("jacobi2d", good, 2),
        StencilRequest("nope", np.zeros((4, 4)), 1),
        StencilRequest("jacobi2d", np.zeros(8), 1),
        StencilRequest("jacobi2d", good, -1),
        StencilRequest("jacobi2d", object(), 1),
        StencilRequest("jacobi2d", good, 2),
    ]
    jsrv = jserve.StencilServer(backend="ref", sweeps=1)
    srv = StencilServer(backend="cuda", sweeps=1, device="cpu")
    for serve, jserve_fn in ((srv.serve, jsrv.serve),
                             (srv.serve_sequential, jsrv.serve_sequential)):
        got, st = serve(reqs)
        with jax.enable_x64(True):
            want, jst = jserve_fn(reqs)
        assert [getattr(r, "error", None) for r in got] == \
            [getattr(r, "error", None) for r in want] == \
            [None, "unknown-spec", "rank-mismatch", "invalid-iters",
             "invalid-grid", None]
        assert [getattr(r, "message", None) for r in got] == \
            [getattr(r, "message", None) for r in want]
        assert (st.n_requests, st.n_rejected) == (jst.n_requests,
                                                   jst.n_rejected) == (6, 4)
        assert equal(got[0], np.asarray(want[0]))
    with pytest.raises(ValueError):
        StencilServer(sweeps=0, device="cpu")
    with pytest.raises(ValueError):
        srv.bucket_key(StencilRequest("jacobi2d", np.zeros(8), 1))


def test_clock_tick_clamp_matches_reference(jserve, rng, monkeypatch):
    from repro.serve import stencil as jst
    assert tstencil._CLOCK_TICK == jst._CLOCK_TICK
    assert tstencil._throughput(10, 0.0) == jst._throughput(10, 0.0) \
        == 10 / tstencil._CLOCK_TICK
    monkeypatch.setattr(tstencil.time, "perf_counter", lambda: 1234.5)
    srv = StencilServer(backend="cuda", sweeps=1, device="cpu")
    reqs = [StencilRequest("jacobi1d", rng.standard_normal(32), 2)]
    for serve in (srv.serve, srv.serve_sequential):
        _, stats = serve(reqs)
        assert stats.seconds == 0.0
        assert stats.requests_per_s > 0 and stats.points_per_s > 0


def test_warm_server_lowers_nothing(rng):
    srv = StencilServer(backend="cuda", sweeps=2, tile="auto", device="cpu")
    reqs = pipeline_requests(rng)
    srv.serve(reqs)
    _, stats = srv.serve(reqs)
    assert stats.plan_cache["lowers"] == 0
    assert stats.plan_cache["autotune_calls"] == 0
    assert stats.plan_cache["misses"] == 0


def test_serve_runs_each_bucket_through_one_batch_handle(rng, monkeypatch):
    """One ``BatchHandle`` stage per bucket, the whole bucket stacked:
    the one-shot server runs the same phases as the continuous one."""
    staged = []
    real = tplan.BatchHandle.stage

    def stage(self, grids):
        staged.append((self.spec.name, len(grids)))
        return real(self, grids)

    monkeypatch.setattr(tplan.BatchHandle, "stage", stage)
    reqs = pipeline_requests(rng)
    got, stats = StencilServer(backend="cuda", sweeps=2,
                               device="cpu").serve(reqs)
    assert sorted(staged) == sorted((b["spec"], b["size"])
                                    for b in stats.buckets)
    specs = tstencil.default_specs()
    single = {name: tplan.runner(specs[name], "cuda", 2, None, "cpu")
              for name, _ in staged}
    for req, out in zip(reqs, got):
        assert torch.equal(out, single[req.spec_name](
            torch.from_numpy(req.grid), req.iters))


def test_runner_cache_stats_has_no_batch_runner():
    assert set(tplan.runner_cache_stats()) == {"runner", "autotune_calls"}


@pytest.mark.parametrize("backend", ("ref", "cuda"))
def test_bucket_past_budget_streams_in_slabs(backend, rng, monkeypatch):
    reqs = [StencilRequest("jacobi2d", rng.standard_normal((48, 40)), 5)
            for _ in range(3)]
    srv = StencilServer(backend=backend, sweeps=2, device="cpu")
    incore, _ = srv.serve(reqs)
    monkeypatch.setenv(tpm.SLAB_BUDGET_ENV, str(48 * 40 * 8 // 2))
    plan = tplan.lower(srv.specs["jacobi2d"], (48, 40), torch.float64,
                       backend=backend, sweeps=2, device="cpu")
    assert plan.streams_from_host and len(plan.slabs) > 1
    got, stats = srv.serve(reqs)
    assert stats.n_slab_streamed == 3
    assert [b["slab_streamed"] for b in stats.buckets] == [True]
    assert all(torch.equal(g, w) for g, w in zip(got, incore))
    seq, _ = srv.serve_sequential(reqs)
    assert all(torch.equal(g, w) for g, w in zip(seq, incore))


def test_bucket_over_budget_runs_in_parts(rng, monkeypatch):
    reqs = [StencilRequest("jacobi2d", rng.standard_normal((48, 40)), 5)
            for _ in range(6)]
    srv = StencilServer(backend="cuda", sweeps=2, device="cpu")
    incore, _ = srv.serve(reqs)
    plan = tplan.lower(srv.specs["jacobi2d"], (48, 40), torch.float64,
                       backend="cuda", sweeps=2, device="cpu")
    monkeypatch.setenv(tpm.SLAB_BUDGET_ENV,
                       str(tplan.incore_device_bytes(plan, 2)))
    plan = tplan.lower(srv.specs["jacobi2d"], (48, 40), torch.float64,
                       backend="cuda", sweeps=2, device="cpu")
    assert not plan.streams_from_host
    from repro_torch.analysis import predicted_launches
    assert predicted_launches(plan, 5, batch=6) == {"K2": 3 * 3}
    got, stats = srv.serve(reqs)
    assert stats.n_slab_streamed == 6
    assert all(torch.equal(g, w) for g, w in zip(got, incore))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert StencilServer().device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StencilServer()


def test_reference_objects_convert(jserve):
    with jax.enable_x64(True):
        jreq = jserve.StencilRequest("jacobi1d", np.arange(8.0), 3)
        jcfg = jserve.ServeConfig.auto(200.0, max_bucket_size=16,
                                       deadline_s=0.5, x64=True)
    req = request_from_reference(jreq)
    assert (req.spec_name, req.iters) == ("jacobi1d", 3)
    assert np.array_equal(req.grid, np.arange(8.0))
    cfg = serve_config_from_reference(jcfg)
    assert (cfg.max_bucket_size, cfg.max_wait_s, cfg.default_deadline_s,
            cfg.pad_buckets) == (16, jcfg.max_wait_s, 0.5, jcfg.pad_buckets)
    assert not hasattr(cfg, "x64")


@pytest.mark.cuda
def test_serve_on_the_card_matches_ref(jserve):
    """On a CUDA device: the mix bitwise equal to the reference and to
    ``backend="ref"`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    reqs = mixed_requests(64, seed=7, dtype=np.float64)
    want = reference_sequential(
        jserve, jserve.mixed_requests(64, seed=7, dtype=np.float64), 4)
    got, _ = StencilServer(backend="cuda", sweeps=4).serve(reqs)
    ref, _ = StencilServer(backend="ref", sweeps=4).serve(reqs)
    assert all(equal(g, w) and torch.equal(g, r)
               for g, w, r in zip(got, want, ref))
