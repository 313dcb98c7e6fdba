"""Serve-config sanity checks: the static analysis of the
continuous-batching server (:mod:`repro_torch.serve.scheduler`).

A copy of ``repro.analysis.serve_check``: pure derivations over the
config's fields, returning :class:`~repro_torch.analysis.verify.Finding`
records.  :class:`repro_torch.serve.scheduler.AsyncStencilServer` runs
:func:`check_serve_config` at construction: error findings raise,
warnings are emitted as Python warnings.  The dispatch-overhead warning
reads the port's own ``perfmodel.SERVE_DISPATCH_OVERHEAD_S``, measured on
the card.
"""
from __future__ import annotations

from .verify import Finding

#: Admission policies the scheduler implements past the high-water mark:
#: ``"reject"`` sheds the newest request at admission.
SHED_POLICIES = ("reject",)


def check_serve_config(config) -> list[Finding]:
    """Sanity-check a :class:`~repro_torch.serve.scheduler.ServeConfig`.

    Errors: ``max_bucket_size`` < 1; ``max_wait_s`` < 0; ``queue_depth``
    below ``max_bucket_size`` (no bucket could ever close full); a
    non-positive ``default_deadline_s``; an unknown ``shed_policy``.

    Warnings: ``max_wait_s`` >= ``default_deadline_s`` (the close timer
    alone can spend the SLO budget); ``max_wait_s`` more than 100x the
    measured per-dispatch overhead with a bucket cap of 1 or 2 (the timer
    holds requests for batching the cap cannot deliver).
    """
    from ..core import perfmodel as _pm

    out: list[Finding] = []
    size = int(config.max_bucket_size)
    wait = float(config.max_wait_s)
    depth = int(config.queue_depth)
    deadline = config.default_deadline_s

    if size < 1:
        out.append(Finding("serve-config", "error",
                           f"max_bucket_size must be >= 1, got {size}"))
    if wait < 0:
        out.append(Finding("serve-config", "error",
                           f"max_wait_s must be >= 0, got {wait}"))
    if size >= 1 and depth < size:
        out.append(Finding(
            "serve-config", "error",
            f"queue_depth {depth} is below max_bucket_size {size}: the "
            f"high-water mark must fit one full bucket or no bucket can "
            f"ever close full"))
    if deadline is not None and not deadline > 0:
        out.append(Finding(
            "serve-config", "error",
            f"default_deadline_s must be positive when set, got "
            f"{deadline}"))
    if config.shed_policy not in SHED_POLICIES:
        out.append(Finding(
            "serve-config", "error",
            f"unknown shed_policy {config.shed_policy!r}; expected one "
            f"of {SHED_POLICIES}"))

    if deadline is not None and deadline > 0 and wait >= deadline:
        out.append(Finding(
            "serve-config", "warning",
            f"max_wait_s {wait} >= default_deadline_s {deadline}: the "
            f"bucket-close timer alone can consume the whole SLO budget"))
    if (size >= 1 and size <= 2
            and wait > 100 * _pm.SERVE_DISPATCH_OVERHEAD_S):
        out.append(Finding(
            "serve-config", "warning",
            f"max_wait_s {wait} holds requests for batching a "
            f"max_bucket_size of {size} cannot amortize (measured "
            f"per-dispatch overhead {_pm.SERVE_DISPATCH_OVERHEAD_S})"))
    return out
