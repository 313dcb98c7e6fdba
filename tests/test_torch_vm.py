"""The port's software SPU and the paper's analytic model vs ``repro``.

* ``repro_torch.core.vm`` (``run_program``, ``execute_plan`` on specs and
  pipelines) against ``repro.core.vm`` on the same numpy grids: f64
  outputs bitwise equal and every event counter equal, over the paper
  stencils x 4 boundaries, the paper pipelines and a staged chain;
* ``backend="vm"`` through ``plan.lower`` and ``CasperEngine`` (on the
  host) against the reference VM, and within ``atol=1e-12`` of
  ``backend="ref"`` (the dense tap order against the factored one);
* ``repro_torch.core.perfmodel``'s paper model (Table 2's machines):
  every constant, sweep cost and table equal to
  ``repro.core.perfmodel``'s, float for float.

Inputs come from ``np.random.default_rng``; JAX f64 is scoped with
``jax.enable_x64(True)``.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import PAPER_PIPELINES as J_PIPES
from repro.core import PAPER_STENCILS as J_SPECS
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.core import vm as jvm
from repro.core.segment import SegmentConfig as JSegment
from repro_torch import CasperEngine, spec_from_reference
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core import ref as tref
from repro_torch.core import vm as tvm
from repro_torch.core.segment import SegmentConfig

BOUNDARIES = ["zero", "constant(0.75)", "periodic", "reflect"]
SHAPES = {1: (150,), 2: (23, 37), 3: (9, 11, 13)}


def _grid(shape, seed=5, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _assert_same(got, want, counters_got, counters_want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
    assert counters_got.as_dict() == counters_want.as_dict()


# ---------------------------------------------------------------------------
# The VM against repro's, bitwise, with its counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", list(J_SPECS))
def test_run_program_bitwise_and_counters(name, boundary):
    ref = J_SPECS[name].with_boundary(boundary)
    port = spec_from_reference(ref)
    g = _grid(SHAPES[ref.ndim])
    with jax.enable_x64(True):
        want, wc = jvm.run_program(ref, g, 3)
    got, gc = tvm.run_program(port, torch.from_numpy(g), 3)
    _assert_same(got, want, gc, wc)


@pytest.mark.parametrize("name", ["jacobi2d", "star33_3d"])
def test_run_program_f32_keeps_dtype_and_bits(name):
    ref = J_SPECS[name]
    g = _grid(SHAPES[ref.ndim], dtype=np.float32)
    want, wc = jvm.run_program(ref, g, 2)
    got, gc = tvm.run_program(spec_from_reference(ref), torch.from_numpy(g),
                              2)
    assert got.dtype == torch.float32
    _assert_same(got, want, gc, wc)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", list(J_PIPES))
def test_execute_plan_pipeline_bitwise_and_counters(name, boundary):
    ref = J_PIPES[name].with_boundary(boundary)
    port = spec_from_reference(ref)
    g = _grid((21, 34), seed=7)
    with jax.enable_x64(True):
        jp = jplan.lower(ref, g.shape, jnp.float64, backend="vm", sweeps=2)
        want, wc = jvm.execute_plan(jp, g, 3)
    tp = tplan.lower(port, g.shape, torch.float64, backend="vm", sweeps=2,
                     device="cpu")
    got, gc = tvm.execute_plan(tp, torch.from_numpy(g), 3)
    _assert_same(got, want, gc, wc)
    # the default count is the plan's sweeps
    got2, _ = tvm.execute_plan(tp, torch.from_numpy(g))
    with jax.enable_x64(True):
        want2, _ = jvm.execute_plan(jp, g)
    np.testing.assert_array_equal(got2.numpy(), want2)


@pytest.mark.parametrize("name", ["jacobi1d", "blur2d", "heat3d"])
def test_execute_plan_spec_matches_reference_plan(name):
    ref = J_SPECS[name].with_boundary("reflect")
    g = _grid(SHAPES[ref.ndim], seed=9)
    with jax.enable_x64(True):
        jp = jplan.lower(ref, g.shape, jnp.float64, backend="vm", sweeps=3)
        want, wc = jvm.execute_plan(jp, g)
    tp = tplan.lower(spec_from_reference(ref), g.shape, torch.float64,
                     backend="vm", sweeps=3, device="cpu")
    got, gc = tvm.execute_plan(tp, torch.from_numpy(g))
    _assert_same(got, want, gc, wc)


def test_vm_plan_fields_match_reference():
    for name, ref in list(J_SPECS.items()) + list(J_PIPES.items()):
        shape = SHAPES[ref.ndim]
        with jax.enable_x64(True):
            jp = jplan.lower(ref, shape, jnp.float64, backend="vm", sweeps=2)
        tp = tplan.lower(spec_from_reference(ref), shape, torch.float64,
                         backend="vm", sweeps=2, device="cpu")
        assert tp.ghost_strategy == jp.ghost_strategy == "stream", name
        assert tp.tile is None and jp.tile is None
        assert tp.slabs is None and tp.slab_budget is None
        assert tp.deep_halo == jp.deep_halo
        assert tp.program.words == jp.program.words


def test_vm_rejects_other_plans():
    tp = tplan.lower(spec_from_reference(J_SPECS["jacobi2d"]), (8, 8),
                     torch.float64, backend="ref", device="cpu")
    with pytest.raises(ValueError, match="not a vm plan"):
        tvm.execute_plan(tp, torch.zeros(8, 8, dtype=torch.float64))


def test_shifted_serves_every_boundary_like_reference():
    g = _grid((6, 7), seed=2)
    for mode, value in (("zero", 0.0), ("constant", 0.75),
                        ("periodic", 0.0), ("reflect", 0.0)):
        for off in ((0, 0), (2, -3), (-1, 4), (-5, 6)):
            want = jvm._shifted(g, off, mode, value)
            got = tvm._shifted(torch.from_numpy(g), off, mode, value)
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# backend="vm" through lowering and the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", ["jacobi1d", "7pt1d", "jacobi2d", "blur2d",
                                  "heat3d", "star33_3d"])
def test_engine_vm_matches_reference_vm_and_ref(name, boundary):
    ref = J_SPECS[name].with_boundary(boundary)
    port = spec_from_reference(ref)
    g = _grid(SHAPES[ref.ndim], seed=11)
    with jax.enable_x64(True):
        want, _ = jvm.run_program(ref, g, 7)
    eng = CasperEngine(port, backend="vm", sweeps=3, device="cpu")
    got = eng.run(g, iters=7)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = tref.run_iterations(port, torch.from_numpy(g), 7)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0,
                               atol=1e-12)
    one = eng.step(g)
    with jax.enable_x64(True):
        want1, _ = jvm.run_program(ref, g, 3)
    np.testing.assert_array_equal(one.numpy(), want1)


@pytest.mark.parametrize("name", list(J_PIPES))
def test_engine_vm_pipeline_and_staged_chain(name):
    ref = J_PIPES[name]
    stages = (ref.stages[0], ref.stages[1].with_boundary("zero"))
    for chain in (ref, dataclasses.replace(ref, name="mixed", stages=stages)):
        port = spec_from_reference(chain)
        g = _grid((19, 24), seed=13)
        with jax.enable_x64(True):
            jp = jplan.lower(chain, g.shape, jnp.float64, backend="vm",
                             sweeps=2)
            want, _ = jvm.execute_plan(jp, g, 5)
        got = CasperEngine(port, backend="vm", sweeps=2,
                           device="cpu").run(g, iters=5)
        np.testing.assert_array_equal(got.numpy(), want)
        assert tplan.lower(port, g.shape, torch.float64, backend="vm",
                           device="cpu").fused == chain.fusable


def test_vm_iters_zero_returns_a_copy():
    port = spec_from_reference(J_SPECS["heat3d"])
    g = torch.from_numpy(_grid(SHAPES[3]))
    out = CasperEngine(port, backend="vm", device="cpu").run(g, iters=0)
    assert torch.equal(out, g) and out.data_ptr() != g.data_ptr()


# ---------------------------------------------------------------------------
# The paper's analytic model, float for float
# ---------------------------------------------------------------------------
PAPER_CONSTANTS = (
    "FREQ", "N_CORES", "N_SPUS", "N_SLICES", "VEC_ELEMS", "ELEM", "LINE",
    "CPU_PEAK_FLOPS", "CPU_COMPUTE_EFFICIENCY", "L1_BYTES", "L2_BYTES",
    "LLC_BYTES", "L2_BW", "LLC_CPU_BW", "LLC_LOCAL_BW", "DRAM_BW",
    "E_CPU_INSTR", "E_SPU_INSTR", "E_L1_HIT", "E_L1_MISS", "E_L2_HIT",
    "E_L2_MISS", "E_L3_HIT", "E_L3_MISS", "E_DRAM", "REMOTE_PENALTY_CYCLES",
    "GPU_BW", "GPU_PEAK_FLOPS", "GPU_AREA_MM2", "GPU_LAUNCH_S", "GPU_FREQ",
    "CASPER_AREA_MM2", "PIMS_ATOMICS_PER_S", "PIMS_INTERNAL_BW",
    "CPU_DRAM_TRAFFIC_FACTOR", "PAPER_TABLE5_CYCLES", "PAPER_TABLE6_ENERGY",
)


@pytest.mark.parametrize("const", PAPER_CONSTANTS)
def test_paper_constants_equal(const):
    assert getattr(tpm, const) == getattr(jpm, const)


@pytest.fixture(scope="module", autouse=True)
def _memoized_reference_remote_fraction():
    """The reference's ``casper_sweep`` walks every grid access for
    ``remote_fraction`` (a pure function of spec, shape and segment), and
    the tests below ask for each cell several times: memoize it for this
    module, as the port's model does, so that the file stays short."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpm, "remote_fraction",
                   functools.lru_cache(maxsize=None)(jpm.remote_fraction))
        yield


def _same_cost(a, b):
    for x, y in ((a.seconds, b.seconds), (a.energy_j, b.energy_j),
                 (a.cycles, b.cycles)):
        assert (math.isnan(x) and math.isnan(y)) or x == y
    assert a.bottleneck == b.bottleneck
    assert a.detail == b.detail


@pytest.mark.parametrize("level", ["L2", "L3", "DRAM"])
@pytest.mark.parametrize("name", list(J_SPECS))
def test_sweep_costs_equal(name, level):
    ref = J_SPECS[name]
    port = spec_from_reference(ref)
    shape = jpm.DOMAIN_SIZES[level][ref.ndim]
    assert tuple(shape) == tuple(tpm.DOMAIN_SIZES[level][port.ndim])
    for fn in ("cpu_sweep", "casper_sweep", "gpu_sweep", "pims_sweep"):
        _same_cost(getattr(tpm, fn)(port, shape),
                   getattr(jpm, fn)(ref, shape))
    _same_cost(tpm.casper_sweep(port, shape, unaligned_hw=False,
                                seg=SegmentConfig(mapping="blocked")),
               jpm.casper_sweep(ref, shape, unaligned_hw=False,
                                seg=JSegment(mapping="blocked")))


def test_tables_equal():
    assert tpm.speedup_table() == jpm.speedup_table()
    assert tpm.energy_table() == jpm.energy_table()
    for name in jpm.PAPER_TABLE5_CYCLES:
        for level in ("L2", "L3", "DRAM"):
            assert (tpm.paper_speedup(name, level)
                    == jpm.paper_speedup(name, level))
            assert (tpm.paper_energy_ratio(name, level)
                    == jpm.paper_energy_ratio(name, level))
