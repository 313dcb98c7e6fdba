"""Seed -> random stage chain, and the seed-pinned regression corpus.

Copies of the reference fuzz harness's generator and corpus
(``tests/test_pipeline_fuzz.py``), building ``repro_torch`` specs from
numpy alone, so that both the CPU parity tests and ``chip_smoke.py`` (on
the card, without JAX) run the same chains; and two separable rank-3
specs beside the paper's (:func:`separable_3d_specs`).  A case is determined by its
seed: the same seed gives the reference harness's taps, coefficients,
boundaries and structures.
"""
import itertools

import numpy as np

from repro_torch.core.stencil import StencilPipeline, StencilSpec

NONPERIODIC = ("zero", "constant(0.5)", "reflect")

# (seed, ndim, periodic, n_stages, sweeps); append, never remove.
REGRESSION_CORPUS = (
    (1, 2, False, 2, 1),
    (7, 2, False, 3, 2),
    (13, 2, True, 2, 2),
    (29, 1, False, 4, 1),
    (31, 1, True, 3, 2),
    (42, 3, False, 2, 1),
    (57, 3, True, 2, 1),
    (101, 2, False, 4, 1),
    (163, 3, False, 2, 2),
    (211, 1, True, 2, 2),
)


def random_spec(rng: np.random.Generator, ndim: int, boundary: str,
                name: str) -> StencilSpec:
    """A random spec: random radius (1-2), random tap set inside the
    radius box (center always present, so specs are well-conditioned),
    random coefficients, randomly forced-dense structure."""
    radius = int(rng.integers(1, 3))
    n_extra = int(rng.integers(1, 5))
    offs = {(0,) * ndim}
    for _ in range(n_extra):
        offs.add(tuple(int(o) for o in
                       rng.integers(-radius, radius + 1, size=ndim)))
    taps = tuple((off, float(np.round(rng.uniform(-1.0, 1.0), 4)))
                 for off in sorted(offs))
    structure = "dense" if rng.random() < 0.25 else "auto"
    return StencilSpec(name, ndim, taps, boundary=boundary,
                       structure=structure)


def random_pipeline(seed: int, ndim: int, periodic: bool,
                    n_stages: int) -> StencilPipeline:
    """A random fusable chain: all stages periodic, or each stage a
    random non-periodic boundary (the two fusable families)."""
    rng = np.random.default_rng(seed)
    stages = tuple(
        random_spec(rng, ndim,
                    "periodic" if periodic
                    else NONPERIODIC[int(rng.integers(len(NONPERIODIC)))],
                    f"fz{seed}_s{k}")
        for k in range(n_stages))
    return StencilPipeline(f"fuzz_pipe_{seed}", stages)


def separable_3d_specs(boundary: str = "zero") -> list[StencilSpec]:
    """Rank-3 separable specs other than star33_3d, whose factored terms
    the streamed kernel reads through its offset tables: ``box3d``, a
    3x3x3 outer product (one term of three factors, dim 0 innermost), and
    ``planebox3d``, a 3x3 box in dims 1-2 (a term of two factors, no dim
    0) plus dim-0 arms (a one-factor term).  Dyadic coefficients, so the
    taps factor exactly."""
    a, b, c = (0.25, 0.5, 0.25), (0.375, 0.5, 0.125), (0.125, 0.75, 0.125)
    box = tuple(((i - 1, j - 1, k - 1), a[i] * b[j] * c[k])
                for i, j, k in itertools.product(range(3), repeat=3))
    plane = tuple(((0, j - 1, k - 1), b[j] * c[k])
                  for j, k in itertools.product(range(3), repeat=2))
    plane += (((-1, 0, 0), 0.0625), ((1, 0, 0), 0.0625))
    return [StencilSpec("box3d", 3, box, boundary=boundary,
                        structure="separable"),
            StencilSpec("planebox3d", 3, plane, boundary=boundary,
                        structure="separable")]
