"""The launch lint: what the reference's jaxpr/HLO lint
(``repro.analysis.jaxpr_lint``) checks, on the port's own evidence.

The port has no jaxpr to walk; its executors are the hand-written kernels
K1-K4 and their wrappers.  The lint holds four properties of a plan,
statically, on any host:

* **dtype contract** (``"dtype-contract"``) — a ``cuda`` plan's dtype has
  a kernel instance (``kernels.engine._ENTRY``) of its own width and an
  accumulator at least as wide (``kernels.engine._acc_dtype``), and an f64
  plan runs the f64 instance with an f64 accumulator: no f64 narrowing.
  The oracle and the VM compute in the grid's own dtype.
* **FMA contraction** (``"fma-contraction"``) — the f64 contract needs
  every product rounded before its add: the kernels are built with
  ``-fmad=false`` (``kernels._build.NVCC_FLAGS``).  The reference could
  only flag the contraction XLA may do across its ``lax.scan`` (an info);
  the port's Python block loop does not fuse blocks, and the kernels'
  flag is checked instead.
* **HBM round trips** (``"hbm-roundtrips"``) — a fused non-periodic
  ``cuda`` pipeline moves fewer device-memory bytes than its staged
  chain (``kernels.engine.hbm_pipeline_traffic``): the point of fusion.
* **launches** (``"launches"``) — the kernel launches the plan makes, an
  info finding: one per fused block, one per stage per chain application
  for a staged chain, one per slab for a streamed block
  (:func:`predicted_launches`); a distributed plan predicts per rank, one
  K2/K4 per fused step and the exchange rounds of each step
  (:func:`predicted_exchange_rounds`).  ``chip_smoke.py`` holds the
  prediction against ``kernels.engine.LAUNCHES`` on the card; a fused
  ``cuda`` plan whose strategy no kernel runs is an error.

The VM backend runs no kernel and is skipped with an info finding.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..core import plan as _plan
from .verify import Finding, Report, summarize_plan

LINT_CHECKS = ("dtype-contract", "fma-contraction", "hbm-roundtrips",
               "launches")


def kernel_of(plan) -> str:
    """The kernel one in-core (or per-slab) block of a fused ``cuda``
    plan launches: K1/K3 pad-free, K2/K4 on a padded or slab window."""
    if plan.ghost_strategy == "pad-free":
        return "K3" if plan.is_pipeline else "K1"
    if plan.ghost_strategy in ("padded-window", "stream-from-host"):
        return "K4" if plan.is_pipeline else "K2"
    raise ValueError(f"no kernel runs a fused cuda plan with strategy "
                     f"{plan.ghost_strategy!r}")


def _block(plan) -> Counter:
    """Launches of one block of ``plan`` on one grid (or one batch in
    core): one, one per slab when it streams, and for a staged chain its
    stage plans' ``sweeps`` times over."""
    if not plan.fused:
        out = Counter()
        for _ in range(plan.sweeps):
            for k in range(len(plan.stages)):
                out += _block(plan.stage_plan(k))
        return out
    return Counter({kernel_of(plan): (len(plan.slabs)
                                      if plan.streams_from_host else 1)})


def _step_rounds(plan) -> int:
    """Exchange rounds of one step of a distributed plan on each rank:
    per sharded dim, two (one per direction) per hop that has a peer —
    every hop on a wrap ring, the hops short of the mesh dim's extent
    otherwise; a staged chain's stage plans, ``sweeps`` times over."""
    if not plan.fused:
        return plan.sweeps * sum(_step_rounds(plan.stage_plan(k))
                                 for k in range(len(plan.stages)))
    total = 0
    for d, name in enumerate(plan.grid_axes):
        if name is None or plan.deep_halo[d] == 0:
            continue
        hops = -(-plan.deep_halo[d] // plan.shard_shape[d])
        if plan.exchange[d] != "wrap-ring":
            hops = min(hops, _plan.mesh_axis_size(plan.mesh, name) - 1)
        total += 2 * hops
    return total


def predicted_exchange_rounds(plan, iters: int | None = None) -> int:
    """Exchange rounds (``core.halo.EXCHANGE["rounds"]``) one rank makes
    in ``iters`` applications (``None``: one step) under a distributed
    ``plan``: ``q`` fused steps and the remainder's; 0 on one device."""
    if not plan.is_distributed:
        return 0
    if iters is None:
        iters = plan.sweeps
    q, r = plan.decompose(iters)
    return q * _step_rounds(plan) + (_step_rounds(plan.remainder(r))
                                     if r else 0)


def predicted_launches(plan, iters: int | None = None,
                       batch: int | None = None) -> dict[str, int]:
    """K1-K4 launches of ``iters`` applications under ``plan`` (``None``:
    one block) on one grid, or on a leading batch of ``batch`` grids, as
    ``plan.run_plan`` makes them: a batch in core is one launch per
    block; a batch the plan leaves on the host runs grid by grid when the
    plan streams, or in core a part at a time
    (``kernels.stream.part_size``) when only the batch is over budget.
    Zero for ``ref`` and ``vm``."""
    if iters is None:
        iters = plan.sweeps
    q, r = plan.decompose(iters)
    if plan.backend not in _plan.KERNEL_BACKENDS or iters == 0:
        return {}
    grids = 1 if batch is None else int(batch)
    if plan.needs_host_streaming:
        from ..kernels import stream as _stream
        per = Counter()
        for p in _stream._block_plans(plan, iters):
            per += _block(p)
        return {k: v * grids for k, v in per.items()}
    if plan.is_distributed and batch is not None:
        raise ValueError("a distributed plan runs one shard per rank, no "
                         "batch")
    per = Counter()
    for _ in range(q):
        per += _block(plan)
    if r:
        per += _block(plan.remainder(r))
    parts = 1
    if (batch is not None and plan.slab_budget is not None
            and _plan.incore_device_bytes(plan, grids) > plan.slab_budget):
        from ..kernels import stream as _stream
        parts = -(-grids // _stream.part_size(plan, grids, iters))
    return {k: v * parts for k, v in per.items()}


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------
def lint_dtype(plan, entry: dict | None = None,
               acc_dtype=None) -> list[Finding]:
    """The kernel instance and accumulator a ``cuda`` plan's dtype gets
    (``entry``/``acc_dtype`` default to the wrapper's own tables)."""
    if plan.backend not in _plan.KERNEL_BACKENDS:
        return []
    from ..kernels import engine as _keng
    entry = _keng._ENTRY if entry is None else entry
    acc_dtype = _keng._acc_dtype if acc_dtype is None else acc_dtype
    dtype = _plan.canonical_dtype(plan.dtype)
    name = entry.get(dtype)
    if name is None:
        return [Finding("dtype-contract", "error",
                        f"no kernel instance for {plan.dtype}")]
    out = []
    want = {torch.float64: "f64", torch.float32: "f32",
            torch.bfloat16: "bf16"}.get(dtype)
    if not name.endswith(f"_{want}"):
        out.append(Finding("dtype-contract", "error",
                           f"{plan.dtype} plan launches {name}"))
    acc = acc_dtype(dtype)
    if acc.itemsize < dtype.itemsize or (dtype == torch.float64
                                         and acc != torch.float64):
        out.append(Finding(
            "dtype-contract", "error",
            f"{plan.dtype} plan accumulates in {acc}: "
            f"{dtype} -> {acc} narrowing breaks the f64 contract"))
    return out


def lint_fma_contraction(plan, flags=None) -> list[Finding]:
    """The kernels' nvcc flags (``flags`` defaults to
    ``kernels._build.NVCC_FLAGS``) forbid contracting a product and its
    add into one FMA."""
    if plan.backend not in _plan.KERNEL_BACKENDS:
        return []
    if flags is None:
        from ..kernels import _build
        flags = _build.NVCC_FLAGS
    if "-fmad=false" not in flags:
        return [Finding(
            "fma-contraction", "error",
            f"the kernels are built without -fmad=false ({list(flags)}): "
            f"nvcc may contract a product and its add, so a {plan.dtype} "
            f"block is no longer bit-identical to the oracle")]
    return []


def lint_hbm(plan, traffic: dict | None = None) -> list[Finding]:
    """A fused non-periodic pipeline moves fewer device-memory bytes than
    its staged chain (``traffic`` defaults to
    ``kernels.engine.hbm_pipeline_traffic`` at the plan's tile)."""
    if traffic is None:
        from ..kernels import engine as _keng
        traffic = _keng.hbm_pipeline_traffic(
            plan.spec, plan.shard_shape or plan.shape, plan.tile, plan.sweeps,
            _plan.canonical_dtype(plan.dtype).itemsize)
    if traffic["fused_bytes"] >= traffic["staged_bytes"]:
        return [Finding(
            "hbm-roundtrips", "error",
            f"fused pipeline moves {traffic['fused_bytes']:.0f} device "
            f"bytes but its staged chain {traffic['staged_bytes']:.0f}: "
            f"fusion is not eliding the intermediate round trips")]
    return []


def lint_launches(plan) -> list[Finding]:
    """The launches of one block, as an info finding (an error when no
    kernel runs the plan's strategy)."""
    try:
        pred = predicted_launches(plan)
    except ValueError as e:
        return [Finding("launches", "error", str(e))]
    return [Finding("launches", "info",
                    f"one block launches {dict(sorted(pred.items()))}"
                    + (f" over {len(plan.slabs)} slabs"
                       if plan.streams_from_host else "")
                    + (f" and {predicted_exchange_rounds(plan)} exchange "
                       f"rounds per rank" if plan.is_distributed else ""))]


def lint_plan(plan, hbm: bool | None = None) -> Report:
    """The lint of ``plan`` as a :class:`~repro_torch.analysis.verify.Report`.
    ``hbm=None`` compares bytes exactly where it means something: a fused
    ``cuda`` pipeline with a non-periodic boundary."""
    if plan.backend == "vm":
        return Report(summarize_plan(plan), ("launch-lint",), (Finding(
            "launch-lint", "info",
            "vm backend runs no kernel; launch lint skipped (the SPU "
            "program is verified by the program check)"),))
    findings = lint_dtype(plan) + lint_fma_contraction(plan)
    if hbm is None:
        hbm = (plan.is_pipeline and plan.fused
               and plan.backend in _plan.KERNEL_BACKENDS
               and plan.boundary_mode != "periodic"
               and plan.tile is not None)
    if hbm:
        findings += lint_hbm(plan)
    findings += lint_launches(plan)
    return Report(summarize_plan(plan), LINT_CHECKS, tuple(findings))
