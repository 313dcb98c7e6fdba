"""The port's continuous-batching server vs ``repro.serve.scheduler``.

The reference's scheduler tests carried over to
:class:`repro_torch.serve.AsyncStencilServer` on ``device="cpu"``
(``ref`` and ``cuda``, the kernels' plain versions): results against
``repro``'s ``serve_sequential`` (f64 bitwise, the reference under
``jax.enable_x64(True)`` through ``tests/_serve_reference.py``), close
reasons, shedding, deadlines, structured rejections, the open-loop
Poisson load, warmup, idempotent stop, a bucket past a forced budget,
padding to tiers, a failed launch failing its bucket with an
``"internal"`` error (nothing reruns elsewhere), ``BatchHandle``'s
phases, and the bucket-close heuristic against the reference's formula.

Every wait has a timeout (``result``, ``wait``, ``drain`` and ``stop``
all take one) and every server stops in a ``finally``: a hung worker
fails its test instead of holding the run.  No test sleeps longer than
0.2 s.
"""
import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import PAPER_STENCILS
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.serve import (AsyncStencilServer, RequestRejected,
                               ServeConfig, StencilRequest, StencilServer,
                               bucket_tiers, default_specs, mixed_requests,
                               poisson_workload, submit_open_loop)

from _serve_reference import jserve, reference_sequential  # noqa: F401

WAIT = 30.0     # seconds any handle may take on this host


def _requests(rng):
    g = lambda shape: rng.standard_normal(shape)
    return [
        StencilRequest("jacobi2d", g((12, 20)), 2),
        StencilRequest("reaction_diffusion2d", g((12, 20)), 2),
        StencilRequest("jacobi2d", g((12, 20)), 2),
        StencilRequest("jacobi1d", g((64,)), 3),
        StencilRequest("jacobi2d", g((12, 20)), 2),
        StencilRequest("reaction_diffusion2d", g((12, 20)), 2),
    ]


def _server(**kw):
    kw.setdefault("backend", "cuda")
    kw.setdefault("sweeps", 2)
    return AsyncStencilServer(device="cpu", **kw)


@contextlib.contextmanager
def _running(**kw):
    """A started server that is stopped, with a timeout, on the way out."""
    server = _server(**kw).start()
    try:
        yield server
    finally:
        server.stop(timeout=WAIT)


def _oracle(req):
    spec = default_specs()[req.spec_name]
    grid = torch.from_numpy(req.grid)
    if hasattr(spec, "stages"):
        return tref.run_pipeline(spec, grid, req.iters)
    return tref.run_iterations(spec, grid, req.iters)


@pytest.mark.parametrize("backend", ("ref", "cuda"))
def test_async_results_bitwise_vs_reference(jserve, backend, rng):
    reqs = _requests(rng)
    want = reference_sequential(jserve, reqs, 2)
    with _running(backend=backend) as server:
        handles = [server.submit(r) for r in reqs]
        server.drain(timeout=WAIT)
    for req, h, w in zip(reqs, handles, want):
        out = h.result(timeout=WAIT)
        assert out.device.type == "cpu" and np.array_equal(out.numpy(), w)
        assert torch.equal(out, _oracle(req))
        assert h.done() and h.error is None and h.latency_s >= 0
    stats = server.stats()
    assert stats.n_requests == len(reqs)
    assert stats.n_rejected == stats.n_shed == 0
    assert sum(b["size"] for b in stats.buckets) == len(reqs)
    lat = stats.latency_s
    assert lat["p50"] <= lat["p99"] <= lat["max"]


@pytest.mark.filterwarnings("ignore:ServeConfig")
def test_arrival_permutation_determinism(rng):
    reqs = _requests(rng)
    runs = []
    for order in (reqs, list(reversed(reqs)), reqs[3:] + reqs[:3]):
        server = _server(config=ServeConfig(max_bucket_size=2,
                                            max_wait_s=60.0), sweeps=1)
        try:
            handles = {id(r): server.submit(r) for r in order}  # pre-start
        finally:
            server.stop(timeout=WAIT)                   # drains
        results = {k: h.result(timeout=WAIT) for k, h in handles.items()}
        runs.append((results, server.stats()))

    def identities(stats):
        return [(b["spec"], b["shape"], b["dtype"], b["iters"], b["size"],
                 b["close_reason"]) for b in stats.buckets]

    base_results, base_stats = runs[0]
    for results, stats in runs[1:]:
        assert all(torch.equal(base_results[k], results[k])
                   for k in base_results)
        assert identities(stats) == identities(base_stats)
        assert stats.close_reasons == base_stats.close_reasons
    assert identities(base_stats) == sorted(identities(base_stats))
    assert base_stats.close_reasons == {"full": 2, "timeout": 0, "drain": 2}


def test_deadline_miss_accounting(rng):
    g = rng.standard_normal((12, 16))
    with _running(sweeps=1) as server:
        missed = [server.submit(StencilRequest("jacobi2d", g, 2),
                                deadline_s=0.0) for _ in range(3)]
        met = [server.submit(StencilRequest("jacobi2d", g, 2),
                             deadline_s=60.0) for _ in range(2)]
        server.drain(timeout=WAIT)
    for h in missed:
        assert h.deadline_missed and h.error is None
        assert h.result(timeout=WAIT).shape == g.shape
    assert not any(h.deadline_missed for h in met)
    assert server.stats().n_deadline_missed == 3


def test_backpressure_sheds_at_high_water(rng):
    server = _server(config=ServeConfig(max_bucket_size=4, queue_depth=4,
                                        max_wait_s=60.0), sweeps=1)
    g = rng.standard_normal((12, 16))
    try:
        handles = [server.submit(StencilRequest("jacobi2d", g, 2))
                   for _ in range(7)]
        shed = [h for h in handles if h.error is not None]
        assert len(shed) == 3
        assert all(h.error.error == "shed" for h in shed)
        for h in shed:
            with pytest.raises(RequestRejected):
                h.result(timeout=WAIT)
    finally:
        server.stop(timeout=WAIT)
    for h in handles[:4]:
        assert h.error is None and h.result(timeout=WAIT).shape == g.shape
    stats = server.stats()
    assert (stats.n_shed, stats.n_requests) == (3, 7)


def test_async_rejects_invalid_requests_structurally(rng):
    with _running(sweeps=1) as server:
        bad = server.submit(StencilRequest("nope", np.zeros((4, 4)), 1))
        rank = server.submit(StencilRequest("jacobi2d", np.zeros(8), 1))
        good = server.submit(StencilRequest(
            "jacobi2d", rng.standard_normal((8, 12)), 1))
        server.drain(timeout=WAIT)
    assert bad.done() and bad.error.error == "unknown-spec"
    assert rank.error.error == "rank-mismatch"
    with pytest.raises(RequestRejected, match="unknown-spec"):
        bad.result(timeout=WAIT)
    assert good.error is None and good.result(timeout=WAIT).shape == (8, 12)
    assert server.stats().n_rejected == 2


def test_poisson_loadgen_bitwise_vs_sequential(jserve):
    reqs = mixed_requests(24, seed=11, dtype=np.float64)
    want = reference_sequential(
        jserve, jserve.mixed_requests(24, seed=11, dtype=np.float64), 2)
    workload = poisson_workload(reqs, rate_rps=600.0, seed=5)
    with _running(config=ServeConfig.auto(600.0)) as server:
        handles = submit_open_loop(server, workload)
        server.drain(timeout=WAIT)
    seq, _ = StencilServer(backend="cuda", sweeps=2,
                           device="cpu").serve_sequential(reqs)
    for h, s, w in zip(handles, seq, want):
        out = h.result(timeout=WAIT)
        assert torch.equal(out, s) and np.array_equal(out.numpy(), w)
    stats = server.stats()
    assert stats.n_requests == len(reqs)
    assert stats.n_shed == stats.n_rejected == 0


def _hang_dispatch(monkeypatch, release):
    """Make every bucket's dispatch block until ``release`` is set (at
    most ``WAIT`` seconds): a hung worker."""
    real = tplan.BatchHandle.dispatch

    def dispatch(self, staged, iters):
        release.wait(WAIT)
        return real(self, staged, iters)

    monkeypatch.setattr(tplan.BatchHandle, "dispatch", dispatch)


def test_drain_times_out_on_a_hung_worker(rng, monkeypatch):
    release = threading.Event()
    _hang_dispatch(monkeypatch, release)
    server = _server(sweeps=1).start()
    try:
        h = server.submit(StencilRequest("jacobi2d",
                                         rng.standard_normal((6, 8)), 1))
        with pytest.raises(TimeoutError, match="1 requests still pending"):
            server.drain(timeout=0.05)
        assert not h.done()
        release.set()
        server.drain(timeout=WAIT)
        assert h.result(timeout=WAIT).shape == (6, 8)
    finally:
        release.set()
        server.stop(timeout=WAIT)


def test_stop_times_out_on_a_hung_worker(rng, monkeypatch):
    release = threading.Event()
    _hang_dispatch(monkeypatch, release)
    server = _server(sweeps=1).start()
    try:
        h = server.submit(StencilRequest("jacobi2d",
                                         rng.standard_normal((6, 8)), 1))
        with pytest.raises(TimeoutError, match="still running"):
            server.stop(timeout=0.05)
    finally:
        release.set()
        server.stop(timeout=WAIT)               # idempotent, now drained
    assert h.result(timeout=WAIT).shape == (6, 8)


@pytest.mark.filterwarnings("ignore:ServeConfig")
def test_bucket_close_reasons(rng):
    g = rng.standard_normal((12, 16))
    with _running(config=ServeConfig(max_bucket_size=2, max_wait_s=0.05),
                  sweeps=1) as server:
        full = [server.submit(StencilRequest("jacobi2d", g, 2))
                for _ in range(2)]
        assert all(h.wait(WAIT) for h in full)
        lone = server.submit(StencilRequest("jacobi2d", g, 5))
        assert lone.wait(WAIT)
    stats = server.stats()
    assert {b["close_reason"] for b in stats.buckets} == {"full", "timeout"}
    assert stats.close_reasons == {"full": 1, "timeout": 1, "drain": 0}


def test_lifecycle_errors():
    server = _server(sweeps=1)
    with pytest.raises(RuntimeError, match="not started"):
        server.drain(timeout=WAIT)
    try:
        server.start()
        server.start()                          # idempotent
    finally:
        server.stop(timeout=WAIT)
    server.stop(timeout=WAIT)                               # idempotent
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(StencilRequest("jacobi2d", np.zeros((4, 6)), 1))
    with pytest.raises(RuntimeError, match="stopped"):
        server.start()


def test_serve_config_validation():
    from repro_torch.analysis import check_serve_config
    for bad in (ServeConfig(max_bucket_size=0), ServeConfig(max_wait_s=-1.0),
                ServeConfig(max_bucket_size=8, queue_depth=4),
                ServeConfig(default_deadline_s=0.0),
                ServeConfig(shed_policy="drop-oldest")):
        assert any(f.severity == "error" for f in check_serve_config(bad))
        with pytest.raises(ValueError, match="invalid ServeConfig"):
            _server(config=bad)
    sus = ServeConfig(max_wait_s=1.0, default_deadline_s=0.5)
    assert any(f.severity == "warning" for f in check_serve_config(sus))
    with pytest.warns(UserWarning, match="SLO budget"):
        _server(config=sus).stop(timeout=WAIT)
    assert check_serve_config(ServeConfig()) == []


def test_bucket_close_wait_matches_reference_formula():
    from repro.core import perfmodel as jpm
    for rate in (10.0, 600.0, 1e4, 1e9):
        for size in (1, 16, 32, 512):
            for deadline in (None, 0.01, 0.5):
                for overhead in (150e-6, tpm.SERVE_DISPATCH_OVERHEAD_S):
                    assert tpm.bucket_close_wait_s(
                        rate, size, deadline_s=deadline,
                        dispatch_overhead_s=overhead) == \
                        jpm.bucket_close_wait_s(
                            rate, size, deadline_s=deadline,
                            dispatch_overhead_s=overhead)
    assert tpm.SERVE_FILL_SLACK == jpm.SERVE_FILL_SLACK
    assert tpm.bucket_close_wait_s(1e9, 32) >= tpm.SERVE_DISPATCH_OVERHEAD_S
    with pytest.raises(ValueError):
        tpm.bucket_close_wait_s(100.0, 0)
    auto = ServeConfig.auto(200.0, max_bucket_size=16, deadline_s=0.5)
    assert auto.max_wait_s == tpm.bucket_close_wait_s(200.0, 16,
                                                      deadline_s=0.5)
    assert auto.default_deadline_s == 0.5


def test_bucket_tiers_match_reference(jserve):
    from repro.serve import scheduler as jsched
    from repro_torch.serve import scheduler as tsched
    for cap in (1, 2, 5, 32, 512):
        assert bucket_tiers(cap) == jsched.bucket_tiers(cap)
        for n in range(1, cap + 1):
            assert tsched._pad_tier(n, cap) == jsched._pad_tier(n, cap)


def test_warmup_runs_every_tier(rng):
    reqs = _requests(rng)
    server = _server(config=ServeConfig(max_bucket_size=8))
    try:
        assert server.warmup(reqs) == 3 * len(bucket_tiers(8))
        before = tplan.plan_cache_stats()["lowers"]
        server.start()
        handles = [server.submit(r) for r in reqs]
        server.drain(timeout=WAIT)
        assert all(h.wait(WAIT) for h in handles)
        assert tplan.plan_cache_stats()["lowers"] == before
    finally:
        server.stop(timeout=WAIT)
    unpadded = _server(config=ServeConfig(max_bucket_size=4,
                                          pad_buckets=False))
    try:
        assert unpadded.warmup(reqs[:1]) == len(bucket_tiers(4))
    finally:
        unpadded.stop(timeout=WAIT)


def test_padding_drops_the_pad_rows(rng):
    assert not ServeConfig().pad_buckets        # off unless asked for
    reqs = [StencilRequest("jacobi2d", rng.standard_normal((12, 20)), 6)
            for _ in range(5)]
    outs = {}
    for pad in (True, False):
        server = _server(config=ServeConfig(max_bucket_size=8,
                                            max_wait_s=60.0,
                                            pad_buckets=pad))
        try:
            handles = [server.submit(r) for r in reqs]
        finally:
            server.stop(timeout=WAIT)
        outs[pad] = [h.result(timeout=WAIT) for h in handles]
        (bucket,) = server.stats().buckets
        assert bucket["size"] == 5
        assert bucket["padded_size"] == (8 if pad else 5)
    assert all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
    assert all(torch.equal(a, _oracle(r)) for a, r in zip(outs[True], reqs))


def test_slab_bucket_under_forced_budget(rng, monkeypatch):
    reqs = [StencilRequest("jacobi2d", rng.standard_normal((48, 40)), 5)
            for _ in range(3)]
    incore, _ = StencilServer(backend="cuda", sweeps=2,
                              device="cpu").serve(reqs)
    monkeypatch.setenv(tpm.SLAB_BUDGET_ENV, str(48 * 40 * 8 // 2))
    server = _server(config=ServeConfig(max_bucket_size=3, max_wait_s=60.0,
                                        pad_buckets=False))
    try:
        handles = [server.submit(r) for r in reqs]
        server.start()
        server.drain(timeout=WAIT)
    finally:
        server.stop(timeout=WAIT)
    assert all(torch.equal(h.result(timeout=WAIT), w)
               for h, w in zip(handles, incore))
    stats = server.stats()
    assert stats.n_slab_streamed == 3
    assert [b["slab_streamed"] for b in stats.buckets] == [True]


def test_failed_launch_fails_its_bucket_only(rng, monkeypatch):
    """A bucket whose launch raises fails its requests with an
    ``"internal"`` error; nothing reruns elsewhere, and the other buckets
    complete."""
    real = tplan.BatchHandle.dispatch

    def dispatch(self, staged, iters):
        if self.spec.name == "jacobi1d":
            raise RuntimeError("K2 launch failed: seeded")
        return real(self, staged, iters)

    monkeypatch.setattr(tplan.BatchHandle, "dispatch", dispatch)
    reqs = _requests(rng)
    with _running() as server:
        handles = [server.submit(r) for r in reqs]
        server.drain(timeout=WAIT)
    for r, h in zip(reqs, handles):
        assert h.wait(WAIT)
        if r.spec_name == "jacobi1d":
            assert h.error.error == "internal"
            assert "seeded" in h.error.message
            with pytest.raises(RequestRejected, match="internal"):
                h.result(timeout=WAIT)
        else:
            assert torch.equal(h.result(timeout=WAIT), _oracle(r))
    assert server.stats().n_rejected == 1


def test_batch_handle_phases_and_donation(rng):
    spec = PAPER_STENCILS["jacobi2d"]
    bh = tplan.batch_handle(spec, "cuda", 2, None, "cpu")
    assert bh == tplan.BatchHandle(spec, "cuda", 2, None, "cpu")
    grids = [rng.standard_normal((12, 20)) for _ in range(3)]
    staged = bh.stage(grids)
    assert staged.tensor.shape == (3, 12, 20) and not staged.on_host
    assert staged.plan.shape == (12, 20) and staged.stage_ms >= 0
    out = bh.fetch(bh.dispatch(staged, 5))
    assert staged.tensor is None                # taken by the dispatch
    for g, o in zip(grids, out):
        assert torch.equal(o, tref.run_iterations(spec, torch.from_numpy(g),
                                                  5))
    tensors = [torch.from_numpy(g) for g in grids]
    again = bh.fetch(bh.dispatch(bh.stage(tensors), 5))
    assert torch.equal(again, out)
    assert dataclasses.is_dataclass(staged)


def test_concurrent_submitters_lose_no_request(rng):
    """Twice as many submitting threads as cores, the interpreter switching
    threads every 10 us: every handle resolves to its own result and the
    window's counters add up (a lost update under the server's lock would
    leave a handle pending or a count short)."""
    import os
    import sys
    import threading
    n_threads = 2 * (os.cpu_count() or 4)
    reqs = [StencilRequest("jacobi1d", rng.standard_normal(24), 1 + i % 3)
            for i in range(20 * n_threads)]
    handles = [[] for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _running(config=ServeConfig(max_bucket_size=4,
                                         max_wait_s=0.001,
                                         queue_depth=len(reqs)),
                      sweeps=1) as server:
            def submit(k):
                for r in reqs[k::n_threads]:
                    handles[k].append((r, server.submit(r)))
            threads = [threading.Thread(target=submit, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
                assert not t.is_alive()
            server.drain(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
    done = [(r, h) for hs in handles for r, h in hs]
    assert len(done) == len(reqs)
    for r, h in done:
        assert torch.equal(h.result(timeout=WAIT), _oracle(r))
    stats = server.stats()
    assert stats.n_requests == len(reqs)
    assert sum(b["size"] for b in stats.buckets) == len(reqs)
    assert stats.n_shed == stats.n_rejected == 0
    assert sum(stats.close_reasons.values()) == stats.n_buckets
