"""The static plan verifier of the PyTorch port: re-derive every
invariant an :class:`~repro_torch.core.plan.ExecutionPlan` is supposed to
satisfy and compare it with what lowering produced.

The counterpart of ``repro.analysis.verify``, with each check re-derived
against the port's own rules: the Hopper shared memory in place of VMEM,
the tile fitted to a small grid, the port's strategy rules and its
in-core and slab charges.  The checks never execute a plan and never
lower one: they re-run the derivations (window arithmetic, iteration
decomposition, the strategy and in-core decisions, the tap
factorization) from the plan's primary inputs and flag every field that
disagrees.  ``plan.lower`` calls :func:`verify_and_record` on every cache
miss: ``strict`` raises :class:`PlanVerificationError` (and the plan is
not cached), ``warn`` (the default) emits a
:class:`PlanVerificationWarning` per error finding, ``off`` skips the
pass (``CASPER_VERIFY`` or :func:`set_verify_mode`).  A second identical
``lower`` is a plan-cache hit and runs no analysis.

The checks keep the reference's names, so that a finding names its
counterpart, except ``"smem-budget"`` (the reference's
``"vmem-budget"``); ``"distributed"`` holds a plan lowered on a
``DeviceMesh`` (its shard shape, exchange strategies and fingerprint).

Severities: ``error`` (an invariant is violated), ``warning`` (legal but
suspicious), ``info`` (an observation, such as a structure forced dense).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Callable

from ..core import perfmodel as _pm
from ..core import plan as _plan
from ..core.stencil import factor_taps, parse_boundary

VERIFY_MODES = ("strict", "warn", "off")

#: Environment variable read (at verification time) when no mode was set
#: through :func:`set_verify_mode`.
VERIFY_ENV = _plan.VERIFY_ENV


# ---------------------------------------------------------------------------
# Findings and reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding: which invariant (``check``), how bad (``severity``)
    and what disagreed (``message``)."""

    check: str
    severity: str
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.check}: {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Report:
    """The checks run over one plan and every finding they produced;
    ``ok`` means no error finding."""

    plan_summary: str
    checks_run: tuple[str, ...]
    findings: tuple[Finding, ...]

    @property
    def errors(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "warning")

    @property
    def infos(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "info")

    @property
    def ok(self) -> bool:
        return not self.errors

    def merged(self, other: "Report") -> "Report":
        """This report and another over the same plan (verifier + lint)."""
        return Report(self.plan_summary, self.checks_run + other.checks_run,
                      self.findings + other.findings)

    def as_dict(self) -> dict:
        return {"plan": self.plan_summary, "ok": self.ok,
                "checks_run": list(self.checks_run),
                "findings": [f.as_dict() for f in self.findings]}

    def pretty(self) -> str:
        lines = [f"plan {self.plan_summary}: {len(self.checks_run)} checks, "
                 f"{len(self.errors)} errors, {len(self.warnings)} warnings, "
                 f"{len(self.infos)} infos"]
        lines += [f"  {f}" for f in self.findings]
        return "\n".join(lines)


class PlanVerificationError(RuntimeError):
    """Raised in strict mode when a new plan violates an invariant; the
    full :class:`Report` is ``.report``."""

    def __init__(self, report: Report):
        super().__init__(report.pretty())
        self.report = report


class PlanVerificationWarning(UserWarning):
    """Emitted in warn mode, once per error finding."""


def summarize_plan(plan) -> str:
    name = getattr(plan.spec, "name", "?")
    return (f"{name}@{plan.shape} {plan.dtype} {plan.backend} "
            f"sweeps={plan.sweeps} {plan.device}")


# ---------------------------------------------------------------------------
# Mode, counters, report cache
# ---------------------------------------------------------------------------
_MODE_OVERRIDE: str | None = None
_LOCK = threading.RLock()
_REPORTS: OrderedDict = OrderedDict()       # plan -> Report
_REPORTS_MAXSIZE = 512
_COUNTERS = {"verifications": 0, "report_cache_hits": 0, "seconds": 0.0}


def verify_mode() -> str:
    """The active mode: the :func:`set_verify_mode` override, else
    ``CASPER_VERIFY``, else ``"warn"``."""
    mode = _MODE_OVERRIDE or os.environ.get(VERIFY_ENV, "warn")
    if mode not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {mode!r}; expected one of "
                         f"{VERIFY_MODES}")
    return mode


def set_verify_mode(mode: str | None) -> None:
    """Set the mode process-wide (``None``: back to ``CASPER_VERIFY`` or
    the default)."""
    global _MODE_OVERRIDE
    if mode is not None and mode not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {mode!r}; expected one of "
                         f"{VERIFY_MODES}")
    _MODE_OVERRIDE = mode


def counters() -> dict:
    """``verifications`` (passes run; cache hits run none),
    ``report_cache_hits`` and ``seconds`` (spent in the passes run)."""
    with _LOCK:
        return dict(_COUNTERS)


def clear_reports() -> None:
    """Drop the report cache and zero the counters."""
    with _LOCK:
        _REPORTS.clear()
        for k in _COUNTERS:
            _COUNTERS[k] = 0


def report_for(plan) -> Report | None:
    """The cached report of ``plan``, if it was verified."""
    with _LOCK:
        return _REPORTS.get(plan)


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------
CHECKS: "OrderedDict[str, Callable]" = OrderedDict()


def _check(name: str):
    def deco(fn):
        CHECKS[name] = fn
        return fn
    return deco


def _itemsize(plan) -> int:
    return _plan.canonical_dtype(plan.dtype).itemsize


def _out_shape(plan) -> tuple[int, ...]:
    """The output a kernel launch of ``plan`` covers: the grid, a
    distributed plan's shard, or for a streamed plan its first (longest)
    slab."""
    if plan.is_distributed and plan.shard_shape is not None:
        return tuple(plan.shard_shape)
    if plan.streams_from_host and plan.slabs:
        start, stop = plan.slabs[0]
        return (stop - start,) + tuple(plan.shape[1:])
    return tuple(plan.shape)


@_check("halo-arithmetic")
def _check_halo(plan) -> list[Finding]:
    """``plan.halo`` is the per-dim sum of the stage radii, re-derived
    from the raw taps, and ``deep_halo == sweeps * halo``."""
    out = []
    ndim = len(plan.shape)
    per_stage = [tuple(max((abs(off[d]) for off, _ in s.taps), default=0)
                       for d in range(ndim)) for s in plan.stages]
    derived = tuple(sum(h) for h in zip(*per_stage))
    if plan.halo != derived:
        out.append(Finding("halo-arithmetic", "error",
                           f"plan.halo={plan.halo} but the stage taps "
                           f"derive {derived}"))
    deep = tuple(plan.sweeps * h for h in derived)
    if plan.deep_halo != deep:
        out.append(Finding("halo-arithmetic", "error",
                           f"plan.deep_halo={plan.deep_halo} but "
                           f"sweeps*halo={deep} (sweeps={plan.sweeps})"))
    return out


@_check("decompose")
def _check_decompose(plan) -> list[Finding]:
    """``decompose(iters) == (q, r)`` with ``iters == q*sweeps + r`` and
    ``0 <= r < sweeps`` over a spread of iteration counts."""
    if plan.sweeps < 1:
        return [Finding("decompose", "error",
                        f"sweeps must be >= 1, got {plan.sweeps}")]
    out = []
    s = plan.sweeps
    for iters in (0, 1, s - 1, s, s + 1, 2 * s, 7 * s + 3):
        q, r = plan.decompose(iters)
        if q * s + r != iters or not 0 <= r < s:
            out.append(Finding(
                "decompose", "error",
                f"decompose({iters}) = ({q}, {r}) violates iters == q*{s} "
                f"+ r with 0 <= r < sweeps"))
    return out


@_check("tile-legality")
def _check_tile(plan) -> list[Finding]:
    """Only a fused ``cuda`` plan carries a tile (a staged chain's stage
    plans carry theirs; ``ref`` and ``vm`` none).  Its rank is the grid's
    and its entries positive; it is fitted to the output it covers (the
    grid, or a streamed plan's slab: :func:`repro_torch.core.plan.fit_tile`
    leaves it unchanged): the fitted default tile for ``tile=None``, the
    requested tile as given, a fitted candidate for ``"auto"``; and a
    non-periodic pad-free window lies inside the grid (else the strategy
    rule takes the padded window).  A distributed plan's tile is fitted
    to its shard."""
    needs_tile = plan.backend in _plan.KERNEL_BACKENDS and plan.fused
    if not needs_tile:
        if plan.tile is not None:
            return [Finding(
                "tile-legality", "error",
                f"{plan.backend}{'' if plan.fused else ' staged'} plan must "
                f"not carry a tile, got {plan.tile}")]
        return []
    tile = plan.tile
    if tile is None:
        return [Finding("tile-legality", "error",
                        f"fused {plan.backend} plan has no tile")]
    if len(tile) != len(plan.shape):
        return [Finding("tile-legality", "error",
                        f"tile rank {len(tile)} != grid rank "
                        f"{len(plan.shape)}")]
    if any(t < 1 for t in tile):
        return [Finding("tile-legality", "error",
                        f"tile entries must be positive, got {tile}")]
    out = []
    itemsize = _itemsize(plan)
    shape = _out_shape(plan)
    req = plan.tile_request
    if req is None:
        want = _plan.normalize_tile(plan.spec, None, plan.sweeps, itemsize,
                                    shape)
    elif req == "auto":
        want = _plan.fit_tile(plan.spec, tile, plan.sweeps, itemsize, shape)
    else:
        want = tuple(req)
    if tuple(tile) != tuple(want):
        out.append(Finding(
            "tile-legality", "error",
            f"tile {tile} but the request {req!r} fitted to the output "
            f"{shape} gives {want}"))
    if (plan.ghost_strategy == "pad-free"
            and plan.boundary_mode != "periodic"):
        win = tuple(t + 2 * d for t, d in zip(tile, plan.deep_halo))
        bad = [d for d, (w, n) in enumerate(zip(win, plan.shape)) if w > n]
        if bad:
            out.append(Finding(
                "tile-legality", "error",
                f"pad-free window {win} exceeds grid {plan.shape} on dims "
                f"{bad}"))
    return out


@_check("smem-budget")
def _check_smem(plan) -> list[Finding]:
    """One CTA's shared memory (:func:`repro_torch.core.plan.smem_bytes`:
    the two window buffers, or the streamed rank-3 kernel's rings and
    tables) at the plan's tile, sweeps and entry fits Hopper's per-block
    limit (``perfmodel.H100_SMEM_PER_BLOCK``).  The pack factor is chosen
    at launch from the batch, so the check covers ``pack=1``."""
    if not (plan.backend in _plan.KERNEL_BACKENDS and plan.fused
            and plan.tile is not None):
        return []
    padded = plan.ghost_strategy != "pad-free"
    need = _plan.smem_bytes(plan.tile, plan.spec, plan.sweeps,
                            _itemsize(plan), padded=padded)
    if need > _pm.H100_SMEM_PER_BLOCK:
        return [Finding(
            "smem-budget", "error",
            f"one CTA needs {need} B of shared memory; Hopper allows "
            f"{_pm.H100_SMEM_PER_BLOCK} B per block (tile={plan.tile}, "
            f"sweeps={plan.sweeps}, {'padded' if padded else 'pad-free'} "
            f"entry)")]
    return []


def _whole_grid_strategy(plan) -> str:
    """The kernel strategy of a fused ``cuda`` plan's grid in core: the
    plan's own tile when it runs in core, else the tile lowering resolves
    for the whole grid (the request fitted, or the analytic tuner's)."""
    itemsize = _itemsize(plan)
    if plan.streams_from_host:
        req = plan.tile_request
        if req == "auto":
            from ..kernels import tune as _tune
            autotune = (_tune.autotune_pipeline if plan.is_pipeline
                        else _tune.autotune)
            tile = autotune(plan.spec, plan.shape, sweeps=plan.sweeps,
                            itemsize=itemsize, backend=plan.backend).tile
        else:
            tile = _plan.normalize_tile(plan.spec, req, plan.sweeps,
                                        itemsize, plan.shape)
    else:
        tile = plan.tile
    return _plan.ghost_strategy_for(plan.spec, plan.shape, itemsize,
                                    plan.sweeps, tile)


@_check("ghost-strategy")
def _check_ghost(plan) -> list[Finding]:
    """Re-run the strategy decision: a non-fusable chain stages, ``vm``
    streams (the SPU serves ghosts at access time), a distributed plan
    pads (``ref``) or reads the exchanged window (``cuda``:
    ``"padded-window"``) and never streams, a ``ref`` or ``cuda``
    block whose device set (``perfmodel.incore_resident_bytes`` with the
    charge of ``plan._incore_charge``: the padded copy of the strategy
    the grid would take in core, the oracle's temporaries) exceeds the
    recorded budget streams from the host, ``ref`` otherwise pads, and
    ``cuda`` takes the pad-free entry for every periodic grid and for a
    grid at least one window large, else the padded window
    (``plan.ghost_strategy_for``)."""
    g = plan.ghost_strategy
    if g not in _plan.GHOST_STRATEGIES:
        return [Finding("ghost-strategy", "error",
                        f"unknown ghost strategy {g!r}")]
    if plan.is_pipeline and not plan.fused:
        expected = "staged"
    elif plan.backend == "vm":
        expected = "stream"
    elif plan.is_distributed:
        expected = "pad" if plan.backend == "ref" else "padded-window"
    else:
        incore = ("pad" if plan.backend == "ref"
                  else _whole_grid_strategy(plan))
        pad, extra = _plan._incore_charge(plan.spec, plan.backend, incore,
                                          plan.deep_halo, plan.sweeps,
                                          len(plan.shape))
        charge = _pm.incore_resident_bytes(plan.shape, _itemsize(plan), pad,
                                           extra)
        budget = (plan.slab_budget if plan.slab_budget is not None
                  else _pm.slab_budget_bytes())
        expected = "stream-from-host" if charge > budget else incore
    if g != expected:
        return [Finding(
            "ghost-strategy", "error",
            f"ghost strategy {g!r} but re-derivation says {expected!r} "
            f"(backend={plan.backend}, boundary={plan.boundary_mode}, "
            f"fused={plan.fused}, distributed={plan.is_distributed}, "
            f"shape={plan.shape})")]
    return []


@_check("slabs")
def _check_slabs(plan) -> list[Finding]:
    """A ``stream-from-host`` plan carries an exact contiguous cover of
    dim 0, an overlap of ``deep_halo[0]`` rows, its budget, and slabs
    whose resident set on the port's executor
    (``perfmodel.slab_resident_bytes``: rings of two windows and two
    outputs, plus the oracle window core's temporaries and restored copy
    for ``ref``) fits that budget (a one-row slab cannot shrink and is
    exempt); every other plan carries no slab fields."""
    if not plan.streams_from_host:
        return [Finding("slabs", "error",
                        f"non-streamed plan carries {field}={val!r}")
                for field, val in (("slabs", plan.slabs),
                                   ("slab_overlap", plan.slab_overlap))
                if val is not None]
    if plan.slab_budget is None:
        return [Finding("slabs", "error",
                        "streamed plan records no slab_budget")]
    if not plan.slabs:
        return [Finding("slabs", "error",
                        f"streamed plan has no slab cover: {plan.slabs!r}")]
    out = []
    prev = 0
    for start, stop in plan.slabs:
        if start != prev:
            out.append(Finding(
                "slabs", "error",
                f"slab cover {'gap' if start > prev else 'overlap'} at "
                f"{start} (previous slab stops at {prev})"))
        if stop <= start:
            out.append(Finding("slabs", "error",
                               f"empty slab ({start}, {stop})"))
        prev = stop
    if prev != plan.shape[0]:
        out.append(Finding("slabs", "error",
                           f"slab cover stops at {prev}, grid extent is "
                           f"{plan.shape[0]}"))
    if plan.slab_overlap != plan.deep_halo[0]:
        out.append(Finding(
            "slabs", "error",
            f"slab overlap {plan.slab_overlap} != sweeps*halo depth "
            f"{plan.deep_halo[0]} (sweeps={plan.sweeps}, halo={plan.halo})"))
    extra = (_plan._oracle_temps(plan.spec) + 1 if plan.backend == "ref"
             else 0)
    for start, stop in plan.slabs:
        length = stop - start
        resident = _pm.slab_resident_bytes(length, plan.shape,
                                           plan.deep_halo, _itemsize(plan),
                                           extra)
        if resident > plan.slab_budget and length > 1:
            out.append(Finding(
                "slabs", "error",
                f"slab ({start}, {stop}) resident set {resident} B exceeds "
                f"budget {plan.slab_budget} B"))
    return out


@_check("fusability")
def _check_fusability(plan) -> list[Finding]:
    """A chain is fusable iff no stage is periodic or every stage is;
    ``plan.fused`` says the same, and a single spec is always fused."""
    if not plan.is_pipeline:
        if not plan.fused:
            return [Finding("fusability", "error",
                            "single-spec plan marked fused=False")]
        return []
    modes = [s.boundary_mode for s in plan.stages]
    fusable = (all(m == "periodic" for m in modes)
               or all(m != "periodic" for m in modes))
    if plan.fused != fusable:
        return [Finding("fusability", "error",
                        f"fused={plan.fused} but stage boundary modes "
                        f"{modes} re-derive fusable={fusable}")]
    return []


def _expand_terms(ndim: int, terms) -> dict:
    """Factor terms expanded to a dense ``offset -> coeff`` map."""
    dense: dict = {}
    for term in terms:
        axes = [f.axis for f in term.factors]
        for combo in itertools.product(*[zip(f.offsets, f.coeffs)
                                         for f in term.factors]):
            off = [0] * ndim
            coeff = 1.0
            for ax, (o, c) in zip(axes, combo):
                off[ax] += o
                coeff *= c
            dense[tuple(off)] = dense.get(tuple(off), 0.0) + coeff
    return dense


@_check("factorization")
def _check_factorization(plan) -> list[Finding]:
    """A single-spec plan pins ``factor_taps(spec)`` (the f64 order), and
    its terms re-expand to the spec's dense taps; a pipeline carries no
    plan-level factorization."""
    if plan.is_pipeline:
        if plan.factorization is not None:
            return [Finding("factorization", "error",
                            "pipeline plan must not carry a plan-level "
                            "factorization")]
        return []
    out = []
    spec = plan.spec
    expected = factor_taps(spec)
    fz = plan.factorization
    if fz != expected:
        got = "None" if fz is None else f"{fz.structure}, tap_ops={fz.tap_ops}"
        out.append(Finding(
            "factorization", "error",
            f"plan.factorization ({got}) != factor_taps(spec) "
            f"({expected.structure}, tap_ops={expected.tap_ops})"))
    if fz is not None and fz.terms is not None:
        dense = _expand_terms(spec.ndim, fz.terms)
        want = {off: c for off, c in spec.taps}
        drift = max((abs(dense.get(k, 0.0) - want.get(k, 0.0))
                     for k in set(dense) | set(want)), default=0.0)
        scale = max((abs(c) for c in want.values()), default=1.0)
        if drift > 1e-9 * max(scale, 1.0):
            out.append(Finding(
                "factorization", "error",
                f"factored terms re-expand with max tap drift {drift:g}"))
    if spec.structure == "dense" and spec.classified_structure != "dense":
        out.append(Finding(
            "factorization", "info",
            f"structure forced dense; the classifier would specialize as "
            f"{spec.classified_structure!r} (tap_ops "
            f"{factor_taps(spec.with_structure('auto')).tap_ops} vs "
            f"{spec.n_taps})"))
    return out


@_check("distributed")
def _check_distributed(plan) -> list[Finding]:
    """A plan lowered on a mesh: its shard extents times the mesh dims'
    sizes reproduce the global grid; each sharded dim's exchange strategy
    is the boundary mode's (``plan.exchange_strategy_for``) and an
    unsharded dim has none; the fingerprint is the mesh's
    (``plan.mesh_fingerprint``); a staged chain carries no exchange (its
    stage plans exchange); a deep halo that needs more hops than the mesh
    dim has shards on a non-ring exchange is flagged (the hops past the
    grid's edge serve fill only).  A single-device plan carries none of
    these fields."""
    out = []
    if plan.mesh is None:
        for field in ("grid_axes", "exchange", "shard_shape",
                      "mesh_fingerprint"):
            if getattr(plan, field) is not None:
                out.append(Finding(
                    "distributed", "error",
                    f"single-device plan carries {field}="
                    f"{getattr(plan, field)!r}"))
        return out
    axes = plan.grid_axes
    if axes is None or len(axes) != len(plan.shape):
        return [Finding("distributed", "error",
                        f"grid_axes {axes!r} does not cover the grid")]
    if plan.mesh_fingerprint != _plan.mesh_fingerprint(plan.mesh, axes):
        out.append(Finding(
            "distributed", "error",
            "mesh_fingerprint does not match the plan's mesh/grid_axes"))
    if plan.shard_shape is None:
        return out + [Finding("distributed", "error",
                              "distributed plan has no shard_shape")]
    sizes = [_plan.mesh_axis_size(plan.mesh, a) for a in axes]
    for d, n in enumerate(plan.shape):
        if plan.shard_shape[d] * sizes[d] != n:
            out.append(Finding(
                "distributed", "error",
                f"shard_shape[{d}]={plan.shard_shape[d]} x mesh dim size "
                f"{sizes[d]} != grid extent {n}"))
    if not plan.fused:
        if plan.exchange is not None:
            out.append(Finding(
                "distributed", "error",
                "staged chain plan must not carry exchange strategies "
                "(its stage plans exchange)"))
        return out
    if plan.exchange is None:
        return out + [Finding("distributed", "error",
                              "fused distributed plan has no exchange "
                              "strategies")]
    for d in range(len(plan.shape)):
        expected = (_plan.exchange_strategy_for(plan.boundary_mode)
                    if axes[d] is not None else None)
        got = plan.exchange[d] if d < len(plan.exchange) else None
        if got != expected:
            out.append(Finding(
                "distributed", "error",
                f"exchange[{d}]={got!r} but boundary "
                f"{plan.boundary_mode!r} on mesh dim {axes[d]!r} requires "
                f"{expected!r}"))
        if axes[d] is not None and plan.shard_shape[d] > 0:
            hops = -(-plan.deep_halo[d] // plan.shard_shape[d])
            if sizes[d] > 1 and hops > sizes[d] and got != "wrap-ring":
                out.append(Finding(
                    "distributed", "warning",
                    f"dim {d}: deep halo {plan.deep_halo[d]} needs {hops} "
                    f"exchange hops but the mesh dim has {sizes[d]} "
                    f"shards; the hops past the grid's edge serve fill "
                    f"only"))
    return out


@_check("program")
def _check_program(plan) -> list[Finding]:
    """The assembled SPU program (``core/isa.py``) agrees with the spec:
    one instruction per tap per stage, the boundary and structure class
    recorded on its stream plan, and a structured instruction count equal
    to the factored tap-op count."""
    out = []
    prog = plan.program
    if plan.is_pipeline:
        stages = getattr(prog, "stages", None)
        if stages is None or len(stages) != plan.spec.n_stages:
            return [Finding(
                "program", "error",
                f"pipeline program has "
                f"{'no' if stages is None else len(stages)} stages, spec "
                f"has {plan.spec.n_stages}")]
        pairs = list(zip(stages, plan.stages))
    else:
        pairs = [(prog, plan.spec)]
    for k, (p, s) in enumerate(pairs):
        where = f"stage {k} " if plan.is_pipeline else ""
        if p.n_instrs != s.n_taps:
            out.append(Finding("program", "error",
                               f"{where}program has {p.n_instrs} "
                               f"instructions for {s.n_taps} taps"))
        if parse_boundary(p.boundary) != (s.boundary_mode, s.boundary_value):
            out.append(Finding("program", "error",
                               f"{where}program records boundary "
                               f"{p.boundary!r}, spec says {s.boundary!r}"))
        fz = factor_taps(s)
        if p.structure != fz.structure:
            out.append(Finding("program", "error",
                               f"{where}program records structure "
                               f"{p.structure!r}, factor_taps says "
                               f"{fz.structure!r}"))
        if p.structured_n_instrs != fz.tap_ops:
            out.append(Finding("program", "error",
                               f"{where}structured instruction count "
                               f"{p.structured_n_instrs} != factored "
                               f"tap_ops {fz.tap_ops}"))
    return out


@_check("plan-fields")
def _check_fields(plan) -> list[Finding]:
    """Field sanity on the port's :class:`ExecutionPlan`: a known backend,
    the canonical torch dtype name and device string, positive extents of
    the spec's rank, and a budget recorded exactly where the in-core
    decision is made (single-device ``ref``/``cuda`` plans; ``vm`` and a
    distributed plan never leave core)."""
    out = []
    if plan.backend not in _plan.BACKENDS:
        out.append(Finding("plan-fields", "error",
                           f"unknown backend {plan.backend!r}"))
    try:
        canonical = _plan.dtype_name(plan.dtype)
    except (TypeError, ValueError):
        canonical = None
    if canonical is None:
        out.append(Finding("plan-fields", "error",
                           f"invalid dtype {plan.dtype!r}"))
    elif plan.dtype != canonical:
        out.append(Finding("plan-fields", "error",
                           f"dtype {plan.dtype!r} not canonical "
                           f"({canonical!r})"))
    try:
        device = _plan.canonical_device(plan.device)
    except (TypeError, RuntimeError):
        device = None
    if plan.device != device:
        out.append(Finding("plan-fields", "error",
                           f"device {plan.device!r} not a canonical torch "
                           f"device string ({device!r})"))
    if len(plan.shape) != plan.spec.ndim:
        out.append(Finding("plan-fields", "error",
                           f"grid rank {len(plan.shape)} != spec ndim "
                           f"{plan.spec.ndim}"))
    if any(n < 1 for n in plan.shape):
        out.append(Finding("plan-fields", "error",
                           f"grid extents must be positive: {plan.shape}"))
    if (plan.slab_budget is None) != (plan.backend == "vm"
                                      or plan.is_distributed):
        out.append(Finding(
            "plan-fields", "error",
            f"{plan.backend} plan records slab_budget={plan.slab_budget!r} "
            "(a single-device ref/cuda plan records the budget it was held "
            "to, a vm or distributed plan none)"))
    elif plan.slab_budget is not None and plan.slab_budget < 1:
        out.append(Finding("plan-fields", "error",
                           f"slab_budget must be >= 1, got "
                           f"{plan.slab_budget}"))
    return out


# ---------------------------------------------------------------------------
# Runner and the lowering hook
# ---------------------------------------------------------------------------
def verify_plan(plan) -> Report:
    """Run :data:`CHECKS` over ``plan`` (no cache, no mode).  A check that
    crashes on a corrupted plan is reported as an error finding."""
    findings: list[Finding] = []
    for name, fn in CHECKS.items():
        try:
            findings.extend(fn(plan))
        except Exception as e:  # corrupted plans may break derivations
            findings.append(Finding(name, "error",
                                    f"check raised {type(e).__name__}: {e}"))
    return Report(summarize_plan(plan), tuple(CHECKS), tuple(findings))


def _verify_cached(plan) -> Report:
    with _LOCK:
        hit = _REPORTS.get(plan)
        if hit is not None:
            _REPORTS.move_to_end(plan)
            _COUNTERS["report_cache_hits"] += 1
            return hit
    t0 = time.perf_counter()
    report = verify_plan(plan)
    seconds = time.perf_counter() - t0
    with _LOCK:
        _COUNTERS["verifications"] += 1
        _COUNTERS["seconds"] += seconds
        _REPORTS[plan] = report
        while len(_REPORTS) > _REPORTS_MAXSIZE:
            _REPORTS.popitem(last=False)
    return report


def verify_and_record(plan) -> Report | None:
    """The ``plan.lower`` hook: ``strict`` raises
    :class:`PlanVerificationError` (the plan is then not cached), ``warn``
    emits one :class:`PlanVerificationWarning` per error finding, ``off``
    skips.  Returns the (cached) report, or ``None`` when off."""
    mode = verify_mode()
    if mode == "off":
        return None
    report = _verify_cached(plan)
    if not report.ok:
        if mode == "strict":
            raise PlanVerificationError(report)
        for f in report.errors:
            warnings.warn(f"{report.plan_summary}: {f}",
                          PlanVerificationWarning, stacklevel=4)
    return report
