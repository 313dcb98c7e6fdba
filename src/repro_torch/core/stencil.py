"""Stencil specifications (the paper's §2.1 objects).

A framework-free copy of ``repro.core.stencil`` for the PyTorch port;
the two must stay equal (``tests/test_torch_spec.py`` holds them so).

A stencil is a fixed pattern of (offset, coefficient) taps applied to every
point of a regular grid.  All six kernels evaluated by the paper (§7.2) are
Jacobi-style: disjoint read/write sets, one FP multiply-accumulate per tap.

Boundary convention: each spec carries a ``boundary`` field selecting how
taps reaching past the grid edge are served.  Every implementation layer
(the reference oracles, the ISA VM, the Pallas engine and the distributed
halo-exchange step) honors the same mode table, so all of them agree
bit-for-bit in f64 under every mode:

====================  =====================================================
``boundary``          ghost value at out-of-grid coordinate ``g``
====================  =====================================================
``"zero"``            ``0`` (the paper's interior-segment closed form)
``"constant(c)"``     the literal ``c`` (Dirichlet wall)
``"periodic"``        ``grid[g mod N]`` per axis (wrap-around torus)
``"reflect"``         ``grid[fold(g)]`` — mirrored about the edge *element*
                      (numpy ``mode="reflect"``: period ``2N-2``, edge not
                      repeated)
====================  =====================================================

See ``docs/boundaries.md`` for the per-mode closed forms used by fused
temporal blocking and the distributed wrap-ring exchange.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import re
from fractions import Fraction
from typing import Mapping, Sequence

Offset = tuple[int, ...]
Tap = tuple[Offset, float]

#: The recognized boundary modes (``constant`` is spelled ``constant(c)``).
BOUNDARY_MODES = ("zero", "constant", "periodic", "reflect")

#: The recognized tap-structure classes (``"auto"`` resolves to one of
#: these at spec construction).  See :func:`factor_taps`.
STRUCTURES = ("star", "separable", "dense")

_CONSTANT_RE = re.compile(r"^constant\((?P<c>[^)]+)\)$")


def parse_boundary(boundary: str) -> tuple[str, float]:
    """``"zero" | "constant(c)" | "periodic" | "reflect"`` → ``(mode, value)``.

    ``value`` is the Dirichlet fill for ``constant`` and ``0.0`` otherwise.
    Raises ``ValueError`` on an unrecognized spelling.
    """
    if boundary in ("zero", "periodic", "reflect"):
        return boundary, 0.0
    m = _CONSTANT_RE.match(boundary)
    if m is not None:
        try:
            return "constant", float(m.group("c"))
        except ValueError:
            pass
    raise ValueError(
        f"unknown boundary {boundary!r}; expected 'zero', 'constant(c)', "
        "'periodic' or 'reflect'")


# ---------------------------------------------------------------------------
# Tap-structure classification (the paper's §4 star/box distinction)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AxisKernel:
    """A 1-D tap kernel along one axis: ``y[p] = sum_j coeffs[j] *
    x[p + offsets[j]·e_axis]``."""

    axis: int
    offsets: tuple[int, ...]
    coeffs: tuple[float, ...]

    @property
    def radius(self) -> int:
        return max(abs(o) for o in self.offsets)


@dataclasses.dataclass(frozen=True)
class FactorTerm:
    """An outer product of 1-D kernels, applied as sequential axis passes
    (ascending axis order).  A single-factor term is a star arm (or the
    center tap); a multi-factor term is a separable box."""

    factors: tuple[AxisKernel, ...]

    @property
    def tap_ops(self) -> int:
        """MACs per output point: the sum (not product) of factor sizes."""
        return sum(len(f.offsets) for f in self.factors)


@dataclasses.dataclass(frozen=True)
class Factorization:
    """How a tap set is computed: a sum of :class:`FactorTerm` s, or the
    dense per-tap fallback (``terms is None``).

    ``tap_ops`` is the per-point MAC count of the factored form (equals
    ``n_taps`` for star/dense; strictly smaller when a separable box was
    factored).  The term order — and the offset order inside each factor —
    is the *pinned f64 accumulation order*: every layer (jnp oracle, numpy
    oracle, Pallas kernel, distributed shard-local path) walks it
    identically, which is what keeps them bit-identical in f64.
    """

    structure: str
    terms: tuple[FactorTerm, ...] | None
    tap_ops: int

    @property
    def compute_terms(self) -> tuple[FactorTerm, ...] | None:
        """Terms the compute layers actually run — factored passes only
        when they beat the dense tap path (``separable``).  A star
        spec's per-tap chain already meets the ``sum(2r_d)+1``
        temporary bound with a single fused accumulation (``tap_ops ==
        n_taps``), so specializing it further would only trade the
        fused chain for extra per-axis intermediates (measured ~equal
        or slightly slower); star therefore keeps the seed's dense tap
        order — and its exact f64 bit pattern."""
        return self.terms if self.structure == "separable" else None


def _nonzero_axes(off: Offset) -> tuple[int, ...]:
    return tuple(d for d, o in enumerate(off) if o)


def _star_terms(ndim: int, taps: Sequence[Tap]) -> tuple[FactorTerm, ...]:
    """Per-axis 1-D kernels for an axis-aligned tap set; the center tap is
    merged into the first axis that carries any taps."""
    per_axis: dict[int, list[tuple[int, float]]] = {d: [] for d in range(ndim)}
    center = [c for o, c in taps if not any(o)]
    for o, c in taps:
        axes = _nonzero_axes(o)
        if axes:
            per_axis[axes[0]].append((o[axes[0]], c))
    first = min((d for d in range(ndim) if per_axis[d]), default=0)
    if center:
        per_axis[first].append((0, center[0]))
    terms = []
    for d in range(ndim):
        if per_axis[d]:
            offs, cs = zip(*sorted(per_axis[d]))
            terms.append(FactorTerm((AxisKernel(d, offs, cs),)))
    return tuple(terms)


def _separable_terms(
    ndim: int, taps: Sequence[Tap], coupled: Sequence[Tap]
) -> tuple[FactorTerm, ...] | None:
    """Try to factor the coupled (≥2 nonzero offset components) taps into
    one outer product of 1-D kernels, verified *exactly* in rationals
    (every float coefficient is an exact binary rational).  Remaining
    axis-aligned taps outside the factored box ride along as star terms.
    Returns ``None`` when the coupled taps do not factor."""
    core_axes = sorted({d for o, _ in coupled for d in _nonzero_axes(o)})
    r = {d: max(abs(o[d]) for o, _ in coupled) for d in core_axes}
    coeff = {o: Fraction(c) for o, c in taps}       # exact binary rationals

    def cget(o: Offset) -> Fraction:
        return coeff.get(o, Fraction(0))

    def axis_offset(d: int, i: int) -> Offset:
        o = [0] * ndim
        o[d] = i
        return tuple(o)

    s = cget((0,) * ndim)                           # pivot: the center tap
    if s == 0:
        return None
    u = {d: {i: cget(axis_offset(d, i)) for i in range(-r[d], r[d] + 1)}
         for d in core_axes}
    k = len(core_axes)
    # Verify D[p]·s^(k-1) == prod_d u_d[p_d] for every coupled position of
    # the core box (including empty positions, whose coefficient is 0).
    for idx in itertools.product(*[range(-r[d], r[d] + 1)
                                   for d in core_axes]):
        if sum(1 for i in idx if i) < 2:
            continue                                # axis slices define u
        o = [0] * ndim
        for d, i in zip(core_axes, idx):
            o[d] = i
        lhs = cget(tuple(o)) * s ** (k - 1)
        rhs = functools.reduce(lambda a, b: a * b,
                               (u[d][i] for d, i in zip(core_axes, idx)))
        if lhs != rhs:
            return None

    # Realize the factors in floats: the first core axis keeps the exact
    # tap coefficients; later axes carry the (possibly rounded) ratio to
    # the pivot, so the product reproduces the box to within 1 ulp per
    # factor (exactly, whenever the ratios are representable).
    factors = []
    for d in core_axes:
        offs = tuple(i for i in range(-r[d], r[d] + 1) if u[d][i] != 0)
        if not offs:
            return None
        cs = tuple(float(u[d][i]) if d == core_axes[0]
                   else float(u[d][i] / s) for i in offs)
        factors.append(AxisKernel(d, offs, cs))

    def in_core(o: Offset) -> bool:
        return all(abs(o[d]) <= r[d] if d in r else o[d] == 0
                   for d in range(ndim))

    remainder = [(o, c) for o, c in taps if not in_core(o)]
    return (FactorTerm(tuple(factors)),) + _star_terms(ndim, remainder)


@functools.lru_cache(maxsize=512)
def _classify(ndim: int, taps: tuple[Tap, ...]) -> Factorization:
    coupled = tuple((o, c) for o, c in taps if len(_nonzero_axes(o)) > 1)
    if not coupled:
        return Factorization("star", _star_terms(ndim, taps), len(taps))
    terms = _separable_terms(ndim, taps, coupled)
    if terms is not None:
        ops = sum(t.tap_ops for t in terms)
        if ops < len(taps):                 # specialize only when it wins
            return Factorization("separable", terms, ops)
    return Factorization("dense", None, len(taps))


def factor_taps(spec: "StencilSpec") -> Factorization:
    """The spec's compute plan: how its taps are classified and factored.

    * ``"star"`` — every tap offset has at most one nonzero component;
      its per-tap shift-add chain already achieves the ``sum(2r_d)+1``
      window-temporary bound (never the ``prod(2r_d+1)`` of a box), so
      the compute layers keep it (``compute_terms is None``) and the
      jaxpr guard pins the bound; ``terms`` still records the per-axis
      kernel view for the ISA/instruction accounting.
    * ``"separable"`` — the coupled taps factor *exactly* (verified in
      rationals) into an outer product of 1-D kernels, computed as
      sequential axis passes; leftover axis taps (e.g. ``star33_3d``'s
      distance-2 arms around its separable ``[1,2,1]³`` core) ride along
      as star terms.
    * ``"dense"`` — the per-tap fallback (also forced by
      ``spec.with_structure("dense")``, which benchmarks use to measure
      the specialization win).

    The factored term/offset order is the pinned f64 accumulation order
    shared by every implementation layer — see :func:`repro_torch.core.ref.tap_sum`.
    """
    if spec.structure == "dense":
        return Factorization("dense", None, spec.n_taps)
    return _classify(spec.ndim, spec.taps)


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A fixed stencil pattern: ``out[p] = sum_k coeff_k * in[p + off_k]``.

    ``boundary`` selects how taps past the grid edge are served (see the
    module docstring mode table); the default ``"zero"`` preserves the
    seed's zero-padding convention.

    ``structure`` records the tap-structure class every compute layer
    dispatches on (see :func:`factor_taps`): the default ``"auto"``
    resolves to the classified ``"star"`` / ``"separable"`` / ``"dense"``
    at construction; passing ``"dense"`` explicitly *forces* the dense
    per-tap path (the benchmarks' baseline), while passing ``"star"`` /
    ``"separable"`` asserts the classification (raises on mismatch).
    """

    name: str
    ndim: int
    taps: tuple[Tap, ...]
    boundary: str = "zero"
    structure: str = "auto"

    def __post_init__(self):
        if self.ndim < 1 or self.ndim > 3:
            raise ValueError(f"ndim must be 1..3, got {self.ndim}")
        seen = set()
        for off, _ in self.taps:
            if len(off) != self.ndim:
                raise ValueError(f"offset {off} rank != ndim {self.ndim}")
            if off in seen:
                raise ValueError(f"duplicate tap offset {off}")
            seen.add(off)
        parse_boundary(self.boundary)   # raises on unknown spelling
        classified = _classify(self.ndim, self.taps).structure
        if self.structure == "auto":
            object.__setattr__(self, "structure", classified)
        elif self.structure not in STRUCTURES:
            raise ValueError(
                f"unknown structure {self.structure!r}; expected 'auto' or "
                f"one of {STRUCTURES}")
        elif self.structure != "dense" and self.structure != classified:
            raise ValueError(
                f"{self.name}: taps classify as {classified!r}, not "
                f"{self.structure!r} (only 'dense' may be forced)")

    @property
    def n_taps(self) -> int:
        return len(self.taps)

    @property
    def boundary_mode(self) -> str:
        """One of :data:`BOUNDARY_MODES` (``constant(c)`` → ``constant``)."""
        return parse_boundary(self.boundary)[0]

    @property
    def boundary_value(self) -> float:
        """The Dirichlet fill ``c`` for ``constant(c)``; ``0.0`` otherwise."""
        return parse_boundary(self.boundary)[1]

    def with_boundary(self, boundary: str) -> "StencilSpec":
        """Same taps under a different boundary mode (validated)."""
        return dataclasses.replace(self, boundary=boundary)

    def with_structure(self, structure: str) -> "StencilSpec":
        """Same taps under a different structure setting (validated);
        ``with_structure("dense")`` forces the dense per-tap path — the
        baseline the structure benchmarks measure against."""
        return dataclasses.replace(self, structure=structure)

    @property
    def factorization(self) -> Factorization:
        """The compute plan for this spec (see :func:`factor_taps`)."""
        return factor_taps(self)

    @property
    def classified_structure(self) -> str:
        """The tap-structure class the classifier derives from the taps
        alone (star / separable / dense), ignoring any ``structure``
        forcing — what ``factorization.structure`` would be without
        ``with_structure("dense")``.  The plan verifier compares the two
        to report specialization deliberately left on the table."""
        return _classify(self.ndim, self.taps).structure

    @property
    def halo(self) -> tuple[int, ...]:
        """Per-dimension halo radius (max |offset| along that dim)."""
        return tuple(
            max((abs(off[d]) for off, _ in self.taps), default=0)
            for d in range(self.ndim)
        )

    @property
    def coeffs(self) -> tuple[float, ...]:
        return tuple(c for _, c in self.taps)

    @property
    def offsets(self) -> tuple[Offset, ...]:
        return tuple(o for o, _ in self.taps)

    def flops_per_point(self) -> int:
        # one multiply-accumulate (2 flops) per tap, as in the paper's SPU.
        # This is the *dense* count (the paper's accounting); the factored
        # compute paths do structured_flops_per_point() instead.
        return 2 * self.n_taps

    def structured_flops_per_point(self) -> int:
        """Flops per point of the actual compute path: one MAC per
        factored tap-op plus one add per extra computed term (the
        term-sum); equals ``flops_per_point()`` for star/dense, whose
        compute path is the dense chain."""
        fz = factor_taps(self)
        terms = fz.compute_terms
        n_terms = 1 if terms is None else len(terms)
        return 2 * fz.tap_ops + (n_terms - 1)

    def bytes_per_point(self, itemsize: int) -> int:
        """Minimum streaming traffic per output point (compulsory only).

        Each input point is read once per sweep (spatial reuse captures the
        taps) and each output written once: the paper's arithmetic-intensity
        accounting of Fig. 1.
        """
        return 2 * itemsize

    def arithmetic_intensity(self, itemsize: int = 8) -> float:
        return self.flops_per_point() / self.bytes_per_point(itemsize)


@dataclasses.dataclass(frozen=True)
class StencilPipeline:
    """A chain of stencil stages applied back-to-back, as one spec.

    One *application* of the pipeline is ``stages[0]`` then ``stages[1]``
    … then ``stages[-1]`` — the operator-split form of multi-kernel
    solvers (advect → diffuse → project; reaction–diffusion splitting).
    Each stage keeps its own taps, boundary mode and structure class.

    A pipeline is accepted everywhere a :class:`StencilSpec` is: the
    lowering pipeline (:mod:`repro.core.plan`; not yet ported) fuses the whole chain into
    one ExecutionPlan whose fetched halo is widened by the *sum* of the
    stage radii per application (``deep_halo = sweeps * halo``), so
    intermediate fields live in VMEM and never round-trip HBM.

    Fusability: between stages, window ghosts must be restored to the
    boundary extension of the *next* stage tile-locally.  The fill and
    mirror modes (zero / constant / reflect) have tile-local closed
    forms at any depth; ``periodic`` ghosts instead evolve correctly *on
    their own* — but only while they hold the periodic extension, i.e.
    while **every** stage is periodic.  A chain mixing periodic with
    non-periodic stages therefore cannot fuse (``fusable`` is False) and
    lowers to staged per-stage execution instead.
    """

    name: str
    stages: tuple[StencilSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        if not self.stages:
            raise ValueError("pipeline needs at least one stage")
        ndim = self.stages[0].ndim
        for s in self.stages:
            if not isinstance(s, StencilSpec):
                raise TypeError(f"pipeline stage {s!r} is not a StencilSpec")
            if s.ndim != ndim:
                raise ValueError(
                    f"stage {s.name!r} ndim {s.ndim} != pipeline ndim {ndim}")

    @property
    def ndim(self) -> int:
        return self.stages[0].ndim

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def stage_names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    @property
    def halo(self) -> tuple[int, ...]:
        """Per-dimension halo of one full application: the *sum* of the
        stage radii (each stage consumes its own layer of the window)."""
        return tuple(sum(s.halo[d] for s in self.stages)
                     for d in range(self.ndim))

    @property
    def boundary_modes(self) -> tuple[str, ...]:
        return tuple(s.boundary_mode for s in self.stages)

    @property
    def boundary_mode(self) -> str:
        """Stage 0's mode — the *initial* window extension (between-stage
        ghosts are restored per the consuming stage's own mode)."""
        return self.stages[0].boundary_mode

    @property
    def boundary_value(self) -> float:
        return self.stages[0].boundary_value

    @property
    def fusable(self) -> bool:
        """Whether the chain admits tile-local fused execution (see the
        class docstring): no periodic stage, or all stages periodic."""
        modes = set(self.boundary_modes)
        return "periodic" not in modes or modes == {"periodic"}

    @property
    def n_taps(self) -> int:
        return sum(s.n_taps for s in self.stages)

    def flops_per_point(self) -> int:
        """Dense MAC flops of one full application (sum over stages)."""
        return sum(s.flops_per_point() for s in self.stages)

    def structured_flops_per_point(self) -> int:
        return sum(s.structured_flops_per_point() for s in self.stages)

    def with_boundary(self, boundary: str) -> "StencilPipeline":
        """Every stage re-based onto ``boundary`` (validated per stage)."""
        return dataclasses.replace(
            self, stages=tuple(s.with_boundary(boundary)
                               for s in self.stages))


def as_stages(spec) -> tuple[StencilSpec, ...]:
    """The stage chain of ``spec``: its own stages for a
    :class:`StencilPipeline`, the 1-tuple ``(spec,)`` for a plain
    :class:`StencilSpec` — so executors can treat both uniformly."""
    if isinstance(spec, StencilPipeline):
        return spec.stages
    return (spec,)


def _star(ndim: int, radius: int, center: float, arm: float) -> tuple[Tap, ...]:
    taps: list[Tap] = [((0,) * ndim, center)]
    for d in range(ndim):
        for r in range(1, radius + 1):
            for sgn in (-1, 1):
                off = [0] * ndim
                off[d] = sgn * r
                taps.append((tuple(off), arm))
    return tuple(taps)


def jacobi1d() -> StencilSpec:
    """Polybench jacobi-1d: out[i] = (a[i-1] + a[i] + a[i+1]) / 3."""
    c = 1.0 / 3.0
    return StencilSpec("jacobi1d", 1, _star(1, 1, c, c))


def seven_point_1d() -> StencilSpec:
    """7-point 1D kernel (Holewinski et al. [174]); offsets -3..3."""
    c = 1.0 / 7.0
    return StencilSpec("7pt1d", 1, _star(1, 3, c, c))


def jacobi2d() -> StencilSpec:
    """Polybench jacobi-2d (the paper's Fig. 2): 0.2 * 5-point star."""
    return StencilSpec("jacobi2d", 2, _star(2, 1, 0.2, 0.2))


def blur2d() -> StencilSpec:
    """5x5 Gaussian blur, separable binomial [1 4 6 4 1]/16 per axis."""
    w = [1.0, 4.0, 6.0, 4.0, 1.0]
    taps = []
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            taps.append(((dy, dx), w[dy + 2] * w[dx + 2] / 256.0))
    return StencilSpec("blur2d", 2, tuple(taps))


def heat3d() -> StencilSpec:
    """7-point 3D heat diffusion (Polybench heat-3d style)."""
    return StencilSpec("heat3d", 3, _star(3, 1, 0.4, 0.1))


def star33_3d() -> StencilSpec:
    """33-point 3D high-order stencil (Datta et al. [43,175]).

    The paper does not publish exact coefficients; we use the common
    high-order composition: dense 3x3x3 core (27 taps) plus the six
    axis-aligned taps at distance 2, normalized to sum 1.  33 taps total.
    """
    taps: list[Tap] = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                dist = abs(dz) + abs(dy) + abs(dx)
                w = {0: 8.0, 1: 4.0, 2: 2.0, 3: 1.0}[dist]
                taps.append(((dz, dy, dx), w))
    for d in range(3):
        for sgn in (-1, 1):
            off = [0, 0, 0]
            off[d] = sgn * 2
            taps.append((tuple(off), 0.5))
    total = sum(c for _, c in taps)
    taps = [(o, c / total) for o, c in taps]
    return StencilSpec("star33_3d", 3, tuple(taps))


def advect1d(courant: float = 0.3) -> StencilSpec:
    """First-order upwind advection on a periodic ring.

    ``out[i] = (1-c)·a[i] + c·a[i-1]`` with Courant number ``c``: the
    canonical periodic-domain workload (mass-conserving — the coefficients
    sum to 1, so under ``boundary="periodic"`` the grid total is exactly
    preserved every sweep).
    """
    c = float(courant)
    return StencilSpec("advect1d", 1, (((0,), 1.0 - c), ((-1,), c)),
                       boundary="periodic")


def advect2d(cy: float = 0.2, cx: float = 0.3) -> StencilSpec:
    """Dimensionally-split upwind advection on a periodic 2-D torus."""
    cy, cx = float(cy), float(cx)
    return StencilSpec(
        "advect2d", 2,
        (((0, 0), 1.0 - cy - cx), ((-1, 0), cy), ((0, -1), cx)),
        boundary="periodic")


def reaction_diffusion2d(d: float = 0.125, k: float = 0.0625,
                         c: float = 0.03125) -> StencilPipeline:
    """Operator-split linearized reaction–diffusion on a no-flux plate.

    Stage 1 (``rd_diffuse``) is explicit diffusion ``u + d·Δu`` (5-point
    star); stage 2 (``rd_react``) the reaction step linearized about the
    homogeneous state — decay ``-k·u`` plus a weak nearest-neighbor
    coupling ``c`` (the inhibitor cross-diffusion surrogate).  Both
    stages use ``reflect`` walls (zero-flux Neumann), so the chain is
    fusable; the default coefficients are exact binary rationals, which
    keeps f64 bit-identity assertions sharp.
    """
    diffuse = StencilSpec("rd_diffuse", 2, _star(2, 1, 1.0 - 4 * d, d),
                          boundary="reflect")
    react = StencilSpec("rd_react", 2, _star(2, 1, 1.0 - k - 4 * c, c),
                        boundary="reflect")
    return StencilPipeline("reaction_diffusion2d", (diffuse, react))


def advect_diffuse2d(cy: float = 0.2, cx: float = 0.3,
                     d: float = 0.125) -> StencilPipeline:
    """Upwind advection then diffusion on a periodic torus — the
    homogeneous-periodic pipeline (fusable: the periodic invariant holds
    across heterogeneous taps, see :class:`StencilPipeline`)."""
    diffuse = StencilSpec("ad_diffuse", 2, _star(2, 1, 1.0 - 4 * d, d),
                          boundary="periodic")
    return StencilPipeline("advect_diffuse2d", (advect2d(cy, cx), diffuse))


PAPER_STENCILS: Mapping[str, StencilSpec] = {
    s.name: s
    for s in (jacobi1d(), seven_point_1d(), jacobi2d(), blur2d(), heat3d(),
              star33_3d())
}

#: The shipped multi-stage workloads, served and benchmarked by name
#: exactly like :data:`PAPER_STENCILS`.
PAPER_PIPELINES: Mapping[str, StencilPipeline] = {
    p.name: p for p in (reaction_diffusion2d(), advect_diffuse2d())
}

# Table 3 domain sizes: dataset level -> {ndim: shape}.
DOMAIN_SIZES: Mapping[str, Mapping[int, tuple[int, ...]]] = {
    "L2": {1: (131072,), 2: (512, 256), 3: (64, 64, 32)},
    "L3": {1: (1048576,), 2: (1024, 1024), 3: (128, 128, 64)},
    "DRAM": {1: (4194304,), 2: (2048, 2048), 3: (256, 256, 64)},
}


def domain_for(spec: StencilSpec, level: str) -> tuple[int, ...]:
    return DOMAIN_SIZES[level][spec.ndim]


def grid_points(shape: Sequence[int]) -> int:
    return math.prod(shape)
