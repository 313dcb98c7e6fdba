"""Differential fuzz harness for the port's fused pipelines: random
stage chains through the port's plans vs the eager chained f64 oracle of
``repro``.

The case generator and the seed-pinned ``REGRESSION_CORPUS`` are copies
of the reference harness's (``tests/test_pipeline_fuzz.py``, which does
not import on this jax), kept in ``tests/_pipeline_cases.py`` so that
``chip_smoke.py`` runs the same chains on the card; a case is determined
by its seed, and the reference's specs are rebuilt from the port's.

Contract per case, against the eager chained per-stage oracle (each
stage one ``repro.core.ref.apply_stencil`` call, in f64):

* the port's ``"cuda"`` plan (on the CPU: the plain versions of K3/K4,
  or of K1/K2 for a staged chain) and its ``"ref"`` plan, executed block
  by block and through ``run_plan``, are bitwise equal — ``run_plan`` is
  a Python loop here, so the reference's 1e-12 allowance for its scan
  does not apply;
* f32 grids agree with the f64 oracle within 1e-4.

A case that differs is a finding to record with its seed, not a
tolerance to widen.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import ref as jref
from repro.core.stencil import StencilPipeline as JPipeline
from repro.core.stencil import StencilSpec as JSpec
from repro_torch import StencilPipeline
from repro_torch.core import plan as tplan

from tests._hypothesis_compat import given, settings, st
from tests._pipeline_cases import (NONPERIODIC, REGRESSION_CORPUS,
                                   random_pipeline, random_spec)

FAST_EXAMPLES = 5      # derandomized: the same cases every run
SHAPES = {1: (23,), 2: (11, 17), 3: (5, 7, 9)}
# small explicit tiles put the larger grids on the pad-free kernel (K3)
SMALL_TILES = {1: (8,), 2: (4, 8), 3: (2, 2, 4)}


def _reference(pipe: StencilPipeline) -> JPipeline:
    return JPipeline(pipe.name, tuple(
        JSpec(s.name, s.ndim, s.taps, boundary=s.boundary,
              structure=s.structure) for s in pipe.stages))


def _oracle(pipe: StencilPipeline, a: np.ndarray, iters: int) -> np.ndarray:
    """The eager chained per-stage f64 oracle of ``repro``."""
    with jax.enable_x64(True):
        want = jnp.asarray(a)
        for _ in range(iters):
            for s in _reference(pipe).stages:
                want = jref.apply_stencil(s, want)
        return np.asarray(want)


def check_port(pipe: StencilPipeline, sweeps: int, f32: bool = False) -> None:
    """Every port executor vs the chained oracle over ``2 * sweeps``
    applications (two fused blocks)."""
    shape = SHAPES[pipe.ndim]
    iters = 2 * sweeps
    a = np.random.default_rng(0).standard_normal(shape)
    want = _oracle(pipe, a, iters)
    g = torch.from_numpy(a.astype(np.float32) if f32 else a)
    for backend, tile in (("cuda", None), ("cuda", SMALL_TILES[pipe.ndim]),
                          ("ref", None)):
        plan = tplan.lower(pipe, shape, g.dtype, backend=backend,
                           sweeps=sweeps, tile=tile, device="cpu")
        assert plan.fused == pipe.fusable
        label = f"{backend} {tile} {plan.ghost_strategy}"
        blocks = g
        for _ in range(iters // sweeps):                 # fused blocks
            blocks = tplan.execute(plan, blocks)
        looped = tplan.run_plan(plan, g, iters)
        for got in (blocks, looped):
            if f32:
                np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                           err_msg=label)
            else:
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=label)


@pytest.mark.parametrize("case", REGRESSION_CORPUS,
                         ids=lambda c: f"seed{c[0]}_nd{c[1]}"
                                       f"{'_per' if c[2] else ''}"
                                       f"_k{c[3]}_t{c[4]}")
def test_regression_corpus(case):
    seed, ndim, periodic, n_stages, sweeps = case
    check_port(random_pipeline(seed, ndim, periodic, n_stages), sweeps)


def test_regression_corpus_f32():
    seed, ndim, periodic, n_stages, sweeps = REGRESSION_CORPUS[1]
    check_port(random_pipeline(seed, ndim, periodic, n_stages), sweeps,
               f32=True)


@settings(max_examples=FAST_EXAMPLES, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       ndim=st.sampled_from((1, 2)),
       periodic=st.booleans(),
       n_stages=st.integers(2, 4),
       sweeps=st.sampled_from((1, 2)))
def test_fuzz_pipelines(seed, ndim, periodic, n_stages, sweeps):
    check_port(random_pipeline(seed, ndim, periodic, n_stages), sweeps)


@settings(max_examples=FAST_EXAMPLES, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       n_stages=st.integers(2, 3),
       sweeps=st.sampled_from((1, 2)))
def test_fuzz_unfusable_staged_fallback(seed, n_stages, sweeps):
    """Mixed periodic/non-periodic chains lower "staged" and still match
    (one single-sweep stage plan per stage)."""
    rng = np.random.default_rng(seed)
    stages = [random_spec(rng, 2, "periodic", f"fz{seed}_p0")]
    stages += [random_spec(rng, 2,
                           NONPERIODIC[int(rng.integers(len(NONPERIODIC)))],
                           f"fz{seed}_s{k}")
               for k in range(1, n_stages)]
    pipe = StencilPipeline(f"fuzz_mixed_{seed}", tuple(stages))
    assert not pipe.fusable
    check_port(pipe, sweeps)
