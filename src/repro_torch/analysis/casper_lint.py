"""casper-lint for the PyTorch port: run the static plan analysis over
the paper matrix as a gate.

    python -m repro_torch.analysis.casper_lint [--device cpu|cuda]
        [--strict] [--no-lint] [--fast] [--out report.json]

The matrix of the reference's ``tools/casper_lint.py``, on the port's
backends: every ``PAPER_STENCILS`` spec x boundary x structure (auto /
forced dense) x backend (``ref``, ``cuda``, ``vm``) x sweeps, every
``PAPER_PIPELINES`` chain (native, and rebased all-periodic and all-zero)
x backend x sweeps, and the streamed cases (:func:`iter_slab_cases`: a
forced ``CASPER_SLAB_BUDGET`` of a quarter of the f64 grid, which sends
``ref`` and ``cuda`` plans to ``"stream-from-host"``).  Each plan is
lowered for ``--device`` (lowering reads no device, so ``cuda`` plans are
checked on any host) in f64 and analyzed: the invariant catalog
(:mod:`repro_torch.analysis.verify`) and, unless ``--no-lint``, the launch
lint (:mod:`repro_torch.analysis.launch_lint`).  Exits 1 on any error
finding; warnings and infos are reported.  ``--out`` writes the full
report as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch

from .. import analysis
from ..core import perfmodel as _pm
from ..core import plan as _plan
from ..core.stencil import PAPER_PIPELINES, PAPER_STENCILS

BOUNDARIES = ("zero", "constant(0.5)", "periodic", "reflect")
SHAPES = {1: (512,), 2: (64, 128), 3: (8, 16, 128)}
SWEEPS = (1, 2)
BACKENDS = ("ref", "cuda", "vm")


def iter_spec_cases(fast: bool):
    for name, spec in PAPER_STENCILS.items():
        for boundary in BOUNDARIES:
            for structure in ("auto", "dense"):
                for backend in BACKENDS:
                    for sweeps in SWEEPS:
                        if fast and (sweeps != 1 or structure != "auto"):
                            continue
                        s = spec.with_boundary(boundary)
                        if structure == "dense":
                            s = s.with_structure("dense")
                        yield (f"{name}/{boundary}/{structure}/{backend}"
                               f"/t{sweeps}", s, SHAPES[spec.ndim], backend,
                               sweeps)


def pipeline_variants(fast: bool):
    """Each paper pipeline as written and, unless ``fast``, with every
    stage rebased onto one mode (both fusable families)."""
    for name, pipe in PAPER_PIPELINES.items():
        yield name, "native", pipe
        if not fast:
            for mode in ("periodic", "zero"):
                stages = tuple(s.with_boundary(mode) for s in pipe.stages)
                yield name, mode, dataclasses.replace(pipe, stages=stages)


def iter_pipeline_cases(fast: bool):
    for name, vname, p in pipeline_variants(fast):
        for backend in BACKENDS:
            for sweeps in SWEEPS if not fast else (1,):
                yield (f"{name}/{vname}/{backend}/t{sweeps}", p, (64, 128),
                       backend, sweeps)


def iter_slab_cases(fast: bool):
    """Streamed cases: each carries a forced ``CASPER_SLAB_BUDGET`` of a
    quarter of the f64 grid, which sends ``ref`` and ``cuda`` plans onto
    the port's slab executor, so the slab invariants (exact cover, a
    ``sweeps*halo`` overlap, the executor's resident set within budget)
    and the per-slab launch prediction are checked.  ``vm`` never leaves
    core."""
    workloads = [("jacobi1d", "zero"), ("jacobi2d", "periodic"),
                 ("blur2d", "constant(0.5)"), ("star33_3d", "reflect")]
    if fast:
        workloads = workloads[:2]
    for name, boundary in workloads:
        spec = PAPER_STENCILS[name].with_boundary(boundary)
        shape = SHAPES[spec.ndim]
        budget = math.prod(shape) * 8 // 4
        for backend in ("ref", "cuda"):
            for sweeps in SWEEPS if not fast else (1,):
                yield (f"{name}/{boundary}/slab/{backend}/t{sweeps}", spec,
                       shape, backend, sweeps, budget)
    for name, pipe in PAPER_PIPELINES.items():
        shape = (64, 128)
        budget = math.prod(shape) * 8 // 4
        for backend in ("ref", "cuda"):
            yield (f"{name}/native/slab/{backend}/t1", pipe, shape, backend,
                   1, budget)


def all_cases(fast: bool) -> list:
    """``(label, spec, shape, backend, sweeps, budget)`` for the whole
    matrix (``budget`` ``None``: the default)."""
    cases = [c + (None,) for c in iter_spec_cases(fast)]
    cases += [c + (None,) for c in iter_pipeline_cases(fast)]
    return cases + list(iter_slab_cases(fast))


def lower_case(spec, shape, backend, sweeps, budget, device):
    """Lower one case in f64 under its budget (``CASPER_SLAB_BUDGET`` is
    part of the plan key, so forced plans never collide with others)."""
    old = os.environ.get(_pm.SLAB_BUDGET_ENV)
    if budget is not None:
        os.environ[_pm.SLAB_BUDGET_ENV] = str(budget)
    try:
        return _plan.lower(spec, shape, torch.float64, backend=backend,
                           sweeps=sweeps, device=device)
    finally:
        if budget is not None:
            if old is None:
                os.environ.pop(_pm.SLAB_BUDGET_ENV, None)
            else:
                os.environ[_pm.SLAB_BUDGET_ENV] = old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the plans are lowered for (default cuda; "
                         "lowering reads no device)")
    ap.add_argument("--strict", action="store_true",
                    help="lower in strict mode: the first violation raises "
                         "PlanVerificationError")
    ap.add_argument("--no-lint", action="store_true",
                    help="the invariant catalog only (no launch lint)")
    ap.add_argument("--fast", action="store_true",
                    help="reduced matrix (sweeps=1, auto structure only)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the JSON report here")
    args = ap.parse_args(argv)

    if args.strict:
        analysis.set_verify_mode("strict")
    t0 = time.time()
    reports: list[tuple[str, analysis.Report]] = []
    n_err = n_warn = n_info = 0
    for label, spec, shape, backend, sweeps, budget in all_cases(args.fast):
        plan = lower_case(spec, shape, backend, sweeps, budget, args.device)
        report = analysis.analyze_plan(plan, lint=not args.no_lint)
        reports.append((label, report))
        n_err += len(report.errors)
        n_warn += len(report.warnings)
        n_info += len(report.infos)
        for f in report.errors + report.warnings:
            print(f"{label}: {f}")
    dt = time.time() - t0
    print(f"casper-lint: {len(reports)} plans analyzed in {dt:.1f}s: "
          f"{n_err} errors, {n_warn} warnings, {n_info} infos; analysis "
          f"counters {analysis.counters()}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"n_plans": len(reports), "n_errors": n_err,
                       "n_warnings": n_warn, "n_infos": n_info,
                       "elapsed_s": dt, "device": args.device,
                       "counters": analysis.counters(),
                       "reports": [dict(case=label, **r.as_dict())
                                   for label, r in reports]}, fh, indent=2)
        print(f"wrote {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
