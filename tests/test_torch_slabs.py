"""The port's out-of-core slab streaming vs ``repro.kernels.stream``.

A forced ``CASPER_SLAB_BUDGET`` pushes small grids onto the
``"stream-from-host"`` path, so the whole matrix runs on the host (K2/K4
through their plain versions, the oracle's window core for ``"ref"``):

* f64 bit-identity of ``kernels.stream.run_plan_streamed`` and of
  ``CasperEngine.run`` against ``repro.kernels.stream.run_plan_streamed``
  and against the port's in-core plan, over rank {1,2,3} x boundary
  {zero, constant, periodic, reflect} x sweeps {1,3} x structure {star,
  separable} on ``"ref"`` and ``"cuda"``, plus the paper pipelines;
* edge cases: one slab, an overlap deeper than a slab, an outermost
  extent the slabs do not divide, remainder iters, ``iters=0``, the
  staged chain whose stage plans stream, a leading batch dim;
* the device budget: in the plan key, the in-core rule (input + output
  + padded copy, the oracle's temporaries, a staged chain's block input,
  a batch whole; a repair over the reference, held against formulas
  written here), ``max_slab_len`` against its formula, an over-budget
  grid left on the host by the plan's one decision (``plan.place``), a
  batch over budget run in parts, the runner's device copy freed after
  the first block, ``tile="auto"`` tuned for the slab;
* ``slab_window`` against the reference's, ``host_device_traffic``
  against the bytes the executor copies, and the executors refusing
  each other's plans.

Inputs come from ``np.random.default_rng``; JAX f64 is scoped with
``jax.enable_x64(True)``.
"""
import contextlib
import dataclasses
import functools
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import PAPER_PIPELINES as J_PIPES
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import plan as jplan
from repro.kernels import stream as jstream
from repro_torch import CasperEngine, spec_from_reference
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.kernels import engine as teng
from repro_torch.kernels import stream as tstream

SHAPES = {1: (64,), 2: (24, 16), 3: (12, 8, 8)}

#: rank -> (star spec, separable spec); rank 1 has no separable
#: factorization, so both entries exercise distinct star radii instead.
SPECS = {
    1: ("jacobi1d", "7pt1d"),
    2: ("jacobi2d", "blur2d"),
    3: ("heat3d", "star33_3d"),
}

BOUNDARIES = ("zero", "constant(0.5)", "periodic", "reflect")
BUDGET_ENV = tpm.SLAB_BUDGET_ENV


@contextlib.contextmanager
def forced_budget(n_bytes: int):
    """Scope ``CASPER_SLAB_BUDGET`` for lowering and for the remainder
    plans lowered mid-run."""
    old = os.environ.get(BUDGET_ENV)
    os.environ[BUDGET_ENV] = str(int(n_bytes))
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(BUDGET_ENV, None)
        else:
            os.environ[BUDGET_ENV] = old


def _host_grid(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape)


def _ref_spec(name, boundary=None):
    spec = J_SPECS[name] if name in J_SPECS else J_PIPES[name]
    return spec if boundary is None else spec.with_boundary(boundary)


@functools.lru_cache(maxsize=None)
def _reference_streamed(name, boundary, shape, sweeps, iters, budget):
    """``repro``'s slab executor (``backend="ref"``) under ``budget``."""
    ref = _ref_spec(name, boundary)
    host = _host_grid(shape)
    with jax.enable_x64(True), forced_budget(budget):
        plan = jplan.lower(ref, shape, jnp.float64, backend="ref",
                           sweeps=sweeps)
        assert plan.needs_host_streaming
        out = np.asarray(jstream.run_plan_streamed(plan, host, iters))
    out.setflags(write=False)
    return out


def _check_streamed(name, boundary, shape, sweeps, iters, backend,
                    budget=None):
    """The port streamed under ``budget`` (default: half the grid's
    bytes, which the reference streams too) against ``repro``'s slab
    executor and against the port's in-core plan, bitwise; returns the
    plan."""
    port = spec_from_reference(_ref_spec(name, boundary))
    host = _host_grid(shape)
    if budget is None:
        budget = host.nbytes // 2
    want = _reference_streamed(name, boundary, tuple(shape), sweeps, iters,
                               budget)
    whole = tplan.lower(port, shape, torch.float64, backend=backend,
                        sweeps=sweeps, device="cpu")
    assert not whole.needs_host_streaming
    incore = tplan.run_plan(whole, torch.from_numpy(host), iters)
    with forced_budget(budget):
        plan = tplan.lower(port, shape, torch.float64, backend=backend,
                           sweeps=sweeps, device="cpu")
        assert plan.needs_host_streaming, plan.ghost_strategy
        got = tstream.run_plan_streamed(plan, torch.from_numpy(host), iters)
        eng = CasperEngine(port, backend=backend, sweeps=sweeps,
                           device="cpu").run(host, iters=iters)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(incore.numpy(), want)
    np.testing.assert_array_equal(eng.numpy(), want)
    assert got.device.type == "cpu"
    return plan


# ---------------------------------------------------------------------------
# The matrix: rank x boundary x sweeps x structure, on ref and cuda
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ("ref", "cuda"))
@pytest.mark.parametrize("ndim", (1, 2, 3))
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("sweeps", (1, 3))
@pytest.mark.parametrize("which", (0, 1), ids=("star", "separable"))
def test_slab_matrix(backend, ndim, boundary, sweeps, which):
    iters = 3 if sweeps == 1 else 7          # 7 = 2*3 + 1: remainder path
    plan = _check_streamed(SPECS[ndim][which], boundary, SHAPES[ndim],
                           sweeps, iters, backend)
    assert plan.streams_from_host
    assert plan.slab_overlap == plan.deep_halo[0]
    assert plan.slabs[0][0] == 0 and plan.slabs[-1][1] == SHAPES[ndim][0]
    if backend == "cuda":
        assert plan.tile is not None
        slab = (plan.slabs[0][1] - plan.slabs[0][0],) + SHAPES[ndim][1:]
        # the tile is the slab's, not the grid's
        assert plan.tile == tplan.normalize_tile(
            plan.spec, None, sweeps, 8, slab)


@pytest.mark.parametrize("backend", ("ref", "cuda"))
@pytest.mark.parametrize("name", sorted(J_PIPES))
def test_slab_fused_pipeline(name, backend):
    assert J_PIPES[name].fusable
    plan = _check_streamed(name, None, (24, 16), 2, 5, backend)
    assert plan.streams_from_host and plan.is_pipeline


def test_slab_staged_pipeline():
    # mixed boundaries: a staged chain; the budget still sends each stage
    # plan through the slab executor (needs_host_streaming)
    pipe = J_PIPES["advect_diffuse2d"]
    stages = (pipe.stages[0], pipe.stages[1].with_boundary("zero"))
    mixed = dataclasses.replace(pipe, name="mixed_ad2d", stages=stages)
    port = spec_from_reference(mixed)
    shape = (24, 16)
    host = _host_grid(shape)
    with jax.enable_x64(True), forced_budget(host.nbytes // 4):
        jp = jplan.lower(mixed, shape, jnp.float64, backend="ref")
        want = np.asarray(jstream.run_plan_streamed(jp, host, 3))
    for backend in ("ref", "cuda"):
        with forced_budget(host.nbytes):
            plan = tplan.lower(port, shape, torch.float64, backend=backend,
                               device="cpu")
            assert not plan.fused
            assert not plan.streams_from_host       # staged: no slab cover
            assert plan.needs_host_streaming        # ...but it streams
            assert plan.stage_plan(0).streams_from_host
            got = tplan.run_plan(plan, torch.from_numpy(host), 3)
            one = CasperEngine(port, backend=backend,
                               device="cpu").step(host)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            one.numpy(), CasperEngine(port, backend=backend,
                                      device="cpu").run(host, 1).numpy())


# ---------------------------------------------------------------------------
# Edge cases
# ---------------------------------------------------------------------------
def test_slab_count_one():
    # outermost extent 1: one slab, whose resident set may exceed the
    # budget (a single row cannot shrink)
    plan = _check_streamed("jacobi2d", None, (1, 64), 1, 2, "cuda",
                           budget=8 * 64 // 2)
    assert plan.slabs == ((0, 1),)


@pytest.mark.parametrize("backend", ("ref", "cuda"))
def test_overlap_deeper_than_slab(backend):
    # every slab a single row while the deep halo is sweeps*halo = 3:
    # each window reaches across several neighbouring slabs
    plan = _check_streamed("jacobi2d", "periodic", (24, 16), 3, 7, backend,
                           budget=1000)
    assert plan.slab_overlap == 3
    assert all(b - a < plan.slab_overlap for a, b in plan.slabs)
    assert len(plan.slabs) == 24


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_non_divisible_outermost(boundary):
    # a budget sized for slabs of 2 rows over an odd extent: the last
    # slab is shorter and the cover still ends at 23
    shape = (23, 16)
    budget = tpm.slab_resident_bytes(2, shape, (2, 2), 8)
    plan = _check_streamed("jacobi2d", boundary, shape, 2, 5, "cuda",
                           budget=budget)
    assert {b - a for a, b in plan.slabs} == {1, 2}
    assert plan.slabs[-1][1] == 23


@pytest.mark.parametrize("iters", (3, 4, 5))
def test_remainder_iters(iters):
    plan = _check_streamed("jacobi1d", "reflect", (64,), 3, iters, "cuda")
    q, r = plan.decompose(iters)
    with forced_budget(64 * 8 // 2):
        blocks = tstream._block_plans(plan, iters)
    assert len(blocks) == q + (1 if r else 0)
    if r:
        assert blocks[-1].sweeps == r and blocks[-1].streams_from_host


def test_batch_dim_streams_each_grid():
    port = spec_from_reference(J_SPECS["blur2d"].with_boundary("reflect"))
    grids = np.stack([_host_grid((24, 16), seed=s) for s in range(3)])
    with forced_budget(grids[0].nbytes):
        eng = CasperEngine(port, backend="cuda", sweeps=2, device="cpu")
        got = eng.run(grids, iters=5)
        one = eng.step(grids)
    for k in range(3):
        want = CasperEngine(port, backend="cuda", sweeps=2,
                            device="cpu").run(grids[k], iters=5)
        np.testing.assert_array_equal(got[k].numpy(), want.numpy())
        np.testing.assert_array_equal(
            one[k].numpy(), CasperEngine(port, backend="cuda", sweeps=2,
                                         device="cpu").run(grids[k], 2))


# ---------------------------------------------------------------------------
# iters=0: a copy, never an alias
# ---------------------------------------------------------------------------
def test_iters_zero_returns_a_copy():
    port = spec_from_reference(J_SPECS["jacobi2d"])
    host = torch.from_numpy(_host_grid((24, 16)))
    with forced_budget(host.numel() * 8):
        plan = tplan.lower(port, host.shape, torch.float64, backend="cuda",
                           device="cpu")
        assert plan.streams_from_host
        out = tplan.run_plan(plan, host, 0)
        streamed = tstream.run_plan_streamed(plan, host, 0)
        eng = CasperEngine(port, backend="cuda", device="cpu").run(host, 0)
    for o in (out, streamed, eng):
        assert torch.equal(o, host)
        assert o.data_ptr() != host.data_ptr()
    out[0, 0] += 1.0
    assert host[0, 0] != out[0, 0]


def test_streamed_run_never_writes_the_input():
    port = spec_from_reference(J_SPECS["heat3d"].with_boundary("periodic"))
    host = torch.from_numpy(_host_grid((12, 8, 8)))
    keep = host.clone()
    with forced_budget(host.numel() * 8):
        out = CasperEngine(port, backend="cuda", sweeps=2,
                           device="cpu").run(host, iters=5)
    assert torch.equal(host, keep)
    assert out.data_ptr() != host.data_ptr()


# ---------------------------------------------------------------------------
# The device budget
# ---------------------------------------------------------------------------
def test_budget_in_plan_key():
    port = spec_from_reference(J_SPECS["jacobi2d"])
    shape = (24, 16)
    plain = tplan.lower(port, shape, torch.float64, backend="cuda",
                        device="cpu")
    assert not plain.streams_from_host
    with forced_budget(24 * 16 * 8):
        streamed = tplan.lower(port, shape, torch.float64, backend="cuda",
                               device="cpu")
        assert streamed.streams_from_host
        before = tplan.plan_cache_stats()
        again = tplan.lower(port, shape, torch.float64, backend="cuda",
                            device="cpu")
        assert again is streamed
        assert tplan.plan_cache_stats()["lowers"] == before["lowers"]
    assert tplan.lower(port, shape, torch.float64, backend="cuda",
                       device="cpu") is plain


def _alloc(n):
    """What the CUDA caching allocator may count for ``n`` bytes: whole
    512-byte granules, and up to 1 MiB it does not split off a block of
    more than 1 MiB."""
    n = -(-n // 512) * 512
    return n + 2 ** 20 if n > 2 ** 20 else n


def _incore_bytes(shape, itemsize, pad=None, extra=0):
    """The in-core rule, written out: input + output and, for a block
    that pads, the padded copy, each as the allocator may count it, and
    ``extra`` more tensors at the padded copy's size."""
    alloc = _alloc
    grid = alloc(math.prod(shape) * itemsize)
    padded = grid if pad is None else alloc(
        math.prod(n + 2 * p for n, p in zip(shape, pad)) * itemsize)
    return 2 * grid + (0 if pad is None else padded) + extra * padded


@pytest.mark.parametrize("backend", ("ref", "cuda"))
def test_grid_between_half_budget_and_budget_streams(backend):
    """A grid of 3/4 of the budget fits by the reference's rule (the grid
    alone) but not in core: input and output take 3/2 of it."""
    ref = J_SPECS["jacobi2d"]
    port = spec_from_reference(ref)
    shape = (48, 64)
    budget = math.prod(shape) * 8 * 4 // 3
    with jax.enable_x64(True), forced_budget(budget):
        assert not jplan.lower(ref, shape, jnp.float64,
                               backend="ref").streams_from_host
    with forced_budget(budget):
        plan = tplan.lower(port, shape, torch.float64, backend=backend,
                           device="cpu")
    assert plan.streams_from_host
    assert _incore_bytes(shape, 8) > budget


def test_incore_rule_matches_formula():
    port = spec_from_reference(J_SPECS["blur2d"])
    for shape, pad in (((64, 64), None), ((64, 64), (8, 8)),
                       ((7, 9), (2, 2)), ((1000,), (3,)),
                       ((1024, 512), (4, 4))):
        for isz in (2, 4, 8):
            assert (tpm.incore_resident_bytes(shape, isz, pad)
                    == _incore_bytes(shape, isz, pad))
    # the padded window (K2) counts its copy: a grid below one window
    # (K2) streams under a budget its input and output fit, and stays in
    # core under one its padded copy fits too
    shape = (12, 200)
    deep = (8, 8)                                    # blur2d at sweeps=4
    for budget, streams in ((_incore_bytes(shape, 8) + 512, True),
                            (_incore_bytes(shape, 8, deep), False)):
        with forced_budget(budget):
            plan = tplan.lower(port, shape, torch.float64, backend="cuda",
                               sweeps=4, device="cpu")
        assert plan.streams_from_host == streams
        if not streams:
            assert plan.ghost_strategy == "padded-window"
    # a pad-free grid stays in core under its input and output
    with forced_budget(_incore_bytes((200, 200), 8) + 512):
        plan = tplan.lower(port, (200, 200), torch.float64, backend="cuda",
                           sweeps=4, device="cpu")
    assert plan.ghost_strategy == "pad-free"


@pytest.mark.parametrize("name,sweeps,extra", [
    ("jacobi2d", 1, 2),          # accumulator and product
    ("jacobi2d", 3, 3),          # and the block's input
    ("blur2d", 4, 4),            # one factored term: its previous pass
    ("star33_3d", 2, 7),         # four terms held for the final sum
    ("reaction_diffusion2d", 1, 3),   # two stages: the block's input
])
def test_oracle_incore_rule_counts_its_temporaries(name, sweeps, extra):
    """``backend="ref"`` is charged the oracle's whole device set: input,
    output, the padded copy of its widest stage and ``extra`` tensors
    (written out per case); it stays in core at that many bytes and
    streams one granule below."""
    ref = _ref_spec(name)
    port = spec_from_reference(ref)
    shape = SHAPES[ref.ndim] if ref.ndim != 2 else (24, 16)
    pad = tuple(max(st.halo[d] for st in port.stages) if hasattr(
        port, "stages") else port.halo[d] for d in range(ref.ndim))
    charge = _incore_bytes(shape, 8, pad, extra)
    for budget, streams in ((charge, False), (charge - 512, True)):
        with forced_budget(budget):
            plan = tplan.lower(port, shape, torch.float64, backend="ref",
                               sweeps=sweeps, device="cpu")
        assert plan.streams_from_host == streams


def test_staged_chain_charges_its_block_input():
    """A staged chain holds its block's input while a later stage runs:
    under a budget every stage block fits but not with that input beside
    it, the chain stays on the host and runs stage by stage in core
    (no stage plan streams), bitwise equal to the in-core run."""
    pipe = J_PIPES["reaction_diffusion2d"]
    stages = (pipe.stages[0].with_boundary("periodic"), pipe.stages[1])
    port = spec_from_reference(dataclasses.replace(pipe, name="mixed_rd",
                                                   stages=stages))
    shape = (24, 16)
    host = torch.from_numpy(_host_grid(shape, seed=9))
    want = CasperEngine(port, backend="cuda", sweeps=2,
                        device="cpu").run(host, iters=3)
    whole = tplan.lower(port, shape, torch.float64, backend="cuda",
                        sweeps=2, device="cpu")
    assert not whole.fused
    stage_most = max(tplan.incore_device_bytes(whole.stage_plan(k))
                     for k in range(2))
    assert tplan.incore_device_bytes(whole) == stage_most + _alloc(
        math.prod(shape) * 8)
    with forced_budget(stage_most):
        plan = tplan.lower(port, shape, torch.float64, backend="cuda",
                           sweeps=2, device="cpu")
        assert plan.needs_host_streaming
        assert not any(plan.stage_plan(k).streams_from_host
                       for k in range(2))
        got = CasperEngine(port, backend="cuda", sweeps=2,
                           device="cpu").run(host, iters=3)
    assert torch.equal(got, want)


def test_runner_frees_its_copy_after_the_first_block(monkeypatch):
    """The runner's own copy of the grid is read by the first block and
    then freed (``plan.run_owned``), so an in-core run allocates one
    block's input, output and padded copy at a time."""
    import weakref
    port = spec_from_reference(J_SPECS["jacobi2d"])
    host = _host_grid((24, 16), seed=4)
    inputs = []
    execute = tplan.execute

    def spy(plan, grid):
        inputs.append(weakref.ref(grid))
        alive = [r() is not None for r in inputs[:-1]]
        assert not any(alive[:-1]), alive     # only the block's own input
        return execute(plan, grid)
    monkeypatch.setattr(tplan, "execute", spy)
    got = CasperEngine(port, backend="cuda", sweeps=2,
                       device="cpu").run(host, iters=6)
    assert len(inputs) == 3 and inputs[0]() is None
    monkeypatch.undo()
    want = CasperEngine(port, backend="ref", sweeps=2,
                        device="cpu").run(host, iters=6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,deep,itemsize,budget", [
    ((24, 16), (3, 3), 8, 1000),
    ((24, 16), (2, 2), 8, 40000),
    ((1024, 512), (4, 4), 8, 2 ** 22),
    ((1024, 512), (4, 4), 8, 2 ** 24 + 12345),
    ((300, 40, 50), (8, 8, 8), 4, 2 ** 20),
    ((4096,), (6,), 8, 4096),
    ((5, 7), (1, 1), 8, 1),
])
@pytest.mark.parametrize("extra", (0, 3))
def test_max_slab_len_matches_formula(shape, deep, itemsize, budget, extra):
    """The executor holds rings of two windows and two outputs:
    ``2*(L + 2*D0)*row + 2*L*out_row``, each ring as the allocator may
    count it, and ``extra`` window-sized temporaries (the oracle's window
    core); the reference's ``2*window + out`` is not the port's."""
    row = itemsize * math.prod(n + 2 * d for n, d in zip(shape[1:],
                                                         deep[1:]))
    out_row = itemsize * math.prod(shape[1:])

    def resident(length):
        window = (length + 2 * deep[0]) * row
        return (_alloc(2 * window) + _alloc(2 * length * out_row)
                + extra * _alloc(window))
    want = 1
    for length in range(1, shape[0] + 1):
        if resident(length) <= budget:
            want = length
    assert tpm.max_slab_len(shape, deep, itemsize, budget, extra) == want
    assert tpm.slab_resident_bytes(want, shape, deep, itemsize, extra) == \
        resident(want)


def test_over_budget_grid_stays_on_the_host():
    """``plan.place`` (the engine's and the runner's placement) returns
    the plan it lowered once and leaves a grid whose plan streams where it
    is; any other goes to the device: ``meta`` stands in for the card."""
    port = spec_from_reference(J_SPECS["jacobi2d"])
    host = torch.from_numpy(_host_grid((24, 16)))
    plan, moved = tplan.place(port, host, "cuda", 1, None, "meta")
    assert moved.device.type == "meta" and not plan.needs_host_streaming
    assert plan is tplan.lower(port, (24, 16), torch.float64,
                               backend="cuda", device="meta")
    with forced_budget(host.numel() * 8):
        plan, kept = tplan.place(port, host, "cuda", 1, None, "meta")
        assert kept is host and plan.streams_from_host
        batch = torch.stack([host, host])
        assert tplan.place(port, batch, "cuda", 1, None, "meta")[1] is batch
        _, numpy_grid = tplan.place(port, host.numpy(), "cuda", 1, None,
                                    "meta")
        assert numpy_grid.device.type == "cpu"
    # the vm never streams: its grid always goes to the device
    with forced_budget(64):
        plan, moved = tplan.place(port, host, "vm", 1, None, "meta")
    assert moved.device.type == "meta" and not plan.needs_host_streaming


@pytest.mark.parametrize("backend", ("ref", "cuda"))
def test_padded_copy_keeps_the_grid_on_the_host(backend):
    """Input and output fit the budget, the padded copy does not (K2's
    ``pad_boundary`` copy of a grid below one window; the oracle's
    per-application pad): the plan streams, ``place`` leaves the grid on
    the host, and the run streams it in slabs, bitwise equal to the
    in-core run."""
    port = spec_from_reference(J_SPECS["blur2d"])
    shape = (12, 200)
    host = torch.from_numpy(_host_grid(shape, seed=5))
    want = CasperEngine(port, backend=backend, sweeps=4,
                        device="cpu").run(host, iters=10)
    with forced_budget(_incore_bytes(shape, 8) + 512):
        plan, kept = tplan.place(port, host, backend, 4, None, "meta")
        assert kept is host and plan.streams_from_host
        tstream.reset_traffic()
        got = CasperEngine(port, backend=backend, sweeps=4,
                           device="cpu").run(host, iters=10)
        traffic = tstream.host_device_traffic(plan, 10)
    assert torch.equal(got, want)
    assert tstream.TRAFFIC == {"h2d": traffic["slab_h2d_bytes"],
                               "d2h": traffic["slab_d2h_bytes"]}


@pytest.mark.parametrize("backend", ("ref", "cuda"))
def test_batch_over_budget_runs_in_parts(backend, monkeypatch):
    """Five grids whose in-core blocks fit the budget two at a time: the
    batch stays on the host and runs in core in parts of 2, 2 and 1,
    bitwise equal to each grid run alone; the charge is the batch's
    input, output and padded copy, written out here."""
    port = spec_from_reference(J_SPECS["jacobi2d"].with_boundary("reflect"))
    shape = (24, 16)
    grids = torch.from_numpy(np.stack([_host_grid(shape, seed=s)
                                       for s in range(5)]))
    plan = tplan.lower(port, shape, torch.float64, backend=backend,
                       sweeps=3, device="cpu")
    # K2 pads ``sweeps*halo``; the oracle pads one halo per application
    # and holds its accumulator, a product and the block's input
    pad, extra = (((3, 3), 0) if backend == "cuda" else ((1, 1), 3))
    assert backend == "ref" or plan.ghost_strategy == "padded-window"
    for m in (1, 2, 5):
        assert tplan.incore_device_bytes(plan, m) == _incore_bytes(
            (m,) + shape, 8, (0,) + pad, extra)
    budget = _incore_bytes((2,) + shape, 8, (0,) + pad, extra)
    wants = [CasperEngine(port, backend=backend, sweeps=3,
                          device="cpu").run(g, iters=7) for g in grids]
    parts = []
    run_owned = tplan.run_owned

    def spy(p, held, iters):
        parts.append(held[0].shape[0])
        return run_owned(p, held, iters)
    with forced_budget(budget):
        plan, kept = tplan.place(port, grids, backend, 3, None, "meta")
        assert kept is grids and not plan.needs_host_streaming
        assert tplan.stays_on_host(plan, grids)
        assert not tplan.stays_on_host(plan, grids[:2])
        monkeypatch.setattr(tplan, "run_owned", spy)
        tstream.reset_traffic()
        got = CasperEngine(port, backend=backend, sweeps=3,
                           device="cpu").run(grids, iters=7)
        one = CasperEngine(port, backend=backend, sweeps=3,
                           device="cpu").step(grids)
    assert parts[-3:] == [2, 2, 1]
    assert tstream.TRAFFIC["h2d"] >= grids.numel() * 8
    for k, want in enumerate(wants):
        assert torch.equal(got[k], want)
        assert torch.equal(one[k], CasperEngine(
            port, backend=backend, sweeps=3, device="cpu").run(grids[k], 3))


@pytest.mark.parametrize("budget_of,tunes", [
    ("input", 1),            # input and output exceed it: the slab's tune
    ("pad", 2),              # the padded copy does: the grid's, the slab's
])
def test_auto_tile_of_a_streamed_plan(budget_of, tunes):
    """``tile="auto"`` tunes for the slab, and every tune is counted: a
    grid whose input and output exceed the budget is tuned once, for its
    slab; one whose padded copy tips it over is tuned for the grid (the
    tile decides the strategy) and again for the slab."""
    port = spec_from_reference(J_SPECS["blur2d"])
    shape = (12, 200)
    budget = (_incore_bytes(shape, 8) - 512 if budget_of == "input"
              else _incore_bytes(shape, 8) + 512)
    tplan.PLAN_CACHE.clear()
    with forced_budget(budget):
        plan = tplan.lower(port, shape, torch.float64, backend="cuda",
                           sweeps=4, tile="auto", device="cpu")
    assert plan.streams_from_host
    stats = tplan.plan_cache_stats()
    assert (stats["lowers"], stats["autotune_calls"]) == (1, tunes)


def test_vm_never_streams():
    port = spec_from_reference(J_SPECS["jacobi2d"])
    with forced_budget(64):
        plan = tplan.lower(port, (24, 16), torch.float64, backend="vm",
                           device="cpu")
    assert plan.ghost_strategy == "stream" and not plan.needs_host_streaming


# ---------------------------------------------------------------------------
# Windows, traffic, and the executors' contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name,shape,budget", [
    ("jacobi1d", (30,), 300),
    ("blur2d", (11, 9), 2000),
    ("star33_3d", (9, 5, 6), 4000),
    ("reaction_diffusion2d", (10, 7), 1000),
])
def test_slab_window_matches_reference(name, shape, budget, boundary):
    ref = _ref_spec(name, boundary)
    port = spec_from_reference(ref)
    host = _host_grid(shape, seed=17)
    with jax.enable_x64(True), forced_budget(host.nbytes // 2):
        jp = jplan.lower(ref, shape, jnp.float64, backend="ref", sweeps=2)
    with forced_budget(budget):
        tp = tplan.lower(port, shape, torch.float64, backend="cuda",
                         sweeps=2, device="cpu")
    assert tp.streams_from_host and tp.slab_overlap == jp.slab_overlap
    ov = tp.slab_overlap
    # every slab, plus ones the reference's cover does not hold
    for slab in set(tp.slabs) | {(0, shape[0]), (1, 2), (shape[0] - 1,
                                                         shape[0])}:
        want = jstream.slab_window(host, slab, ov, jp)
        got = tstream.slab_window(torch.from_numpy(host), slab, ov, tp)
        np.testing.assert_array_equal(got.numpy(), want)


def test_slab_window_rejects_another_overlap():
    port = spec_from_reference(J_SPECS["jacobi2d"])
    with forced_budget(1000):
        tp = tplan.lower(port, (24, 16), torch.float64, backend="cuda",
                         sweeps=2, device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        tstream.slab_window(torch.zeros(24, 16, dtype=torch.float64),
                            (0, 1), 5, tp)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("iters", (None, 5))
def test_host_device_traffic_counts_the_copies(boundary, iters):
    port = spec_from_reference(J_SPECS["jacobi2d"].with_boundary(boundary))
    host = torch.from_numpy(_host_grid((24, 16)))
    with forced_budget(24 * 16 * 8 // 2):
        plan = tplan.lower(port, (24, 16), torch.float64, backend="cuda",
                           sweeps=2, device="cpu")
        t = tstream.host_device_traffic(plan, iters)
        tstream.reset_traffic()
        if iters is None:
            tstream.execute_plan(plan, host)
        else:
            tstream.run_plan_streamed(plan, host, iters)
    assert t["slab_h2d_bytes"] == tstream.TRAFFIC["h2d"]
    assert t["slab_d2h_bytes"] == tstream.TRAFFIC["d2h"]
    assert t["blocks"] == (1 if iters is None else 3)  # 5 = 2*2 + 1
    assert t["n_slabs"] == len(plan.slabs)
    assert t["whole_h2d_bytes"] == t["whole_d2h_bytes"] == 24 * 16 * 8
    assert t["slab_d2h_bytes"] == t["blocks"] * 24 * 16 * 8
    assert t["overhead"] > 1.0 or boundary in ("zero", "constant(0.5)")
    with jax.enable_x64(True), forced_budget(24 * 16 * 8 // 2):
        jp = jplan.lower(J_SPECS["jacobi2d"].with_boundary(boundary),
                         (24, 16), jnp.float64, backend="ref", sweeps=2)
    assert set(t) == set(jstream.host_device_traffic(jp, iters))


def test_executors_refuse_each_others_plans():
    port = spec_from_reference(J_SPECS["jacobi2d"])
    grid = torch.zeros(24, 16, dtype=torch.float64)
    incore = tplan.lower(port, (24, 16), torch.float64, backend="cuda",
                         device="cpu")
    with pytest.raises(ValueError, match="not a slab-streamed plan"):
        tstream.execute_plan(incore, grid)
    with forced_budget(1000):
        streamed = tplan.lower(port, (24, 16), torch.float64, backend="cuda",
                               device="cpu")
    with pytest.raises(ValueError, match="ghost strategy"):
        teng.execute_plan(streamed, grid)
    with pytest.raises(ValueError, match="plan shape"):
        tstream.execute_plan(streamed, torch.zeros(23, 16,
                                                   dtype=torch.float64))


def test_execute_plan_one_block_matches_reference():
    ref = J_SPECS["star33_3d"].with_boundary("constant(0.5)")
    host = _host_grid((12, 8, 8))
    with jax.enable_x64(True), forced_budget(host.nbytes // 2):
        jp = jplan.lower(ref, host.shape, jnp.float64, backend="ref",
                         sweeps=2)
        want = np.asarray(jstream.execute_plan(jp, host))
    with forced_budget(host.nbytes // 2):
        tp = tplan.lower(spec_from_reference(ref), host.shape, torch.float64,
                         backend="cuda", sweeps=2, device="cpu")
    got = tstream.execute_plan(tp, torch.from_numpy(host))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tplan.execute(tp, torch.from_numpy(host)).numpy(), want)


def test_window_sweep_writes_into_out():
    port = spec_from_reference(J_SPECS["blur2d"].with_boundary("periodic"))
    g = torch.from_numpy(_host_grid((20, 12)))
    with forced_budget(1000):
        plan = tplan.lower(port, (20, 12), torch.float64, backend="cuda",
                           sweeps=2, device="cpu")
    start, stop = plan.slabs[1]
    w = tstream.slab_window(g, (start, stop), plan.slab_overlap, plan)
    out = torch.empty((stop - start, 12), dtype=torch.float64)
    got = teng.stencil_window_sweep(port, w, out.shape, (start, 0),
                                    (20, 12), plan.tile, 2, out=out)
    assert got is out
    want = teng.stencil_window_sweep(port, w, out.shape, (start, 0),
                                     (20, 12), plan.tile, 2)
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="out"):
        teng.stencil_window_sweep(port, w, out.shape, (start, 0), (20, 12),
                                  plan.tile, 2, out=out.float())
