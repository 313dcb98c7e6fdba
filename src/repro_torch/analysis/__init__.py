"""Static plan analysis of the PyTorch port: prove every
:class:`~repro_torch.core.plan.ExecutionPlan` before it runs.

* :mod:`repro_torch.analysis.verify` — the invariant catalog, re-derived
  against the port's rules; runs on every ``plan.lower`` cache miss
  (``CASPER_VERIFY`` = ``strict`` / ``warn`` / ``off``).
* :mod:`repro_torch.analysis.launch_lint` — the counterpart of the
  reference's jaxpr/HLO lint: dtype contract, FMA contraction, fused vs
  staged bytes and the launches a plan makes; on demand through
  :func:`analyze_plan`, ``CasperEngine.analyze`` or
  ``python -m repro_torch.analysis.casper_lint``.
* :mod:`repro_torch.analysis.serve_check` — the serving config's checks.
"""
from .verify import (
    CHECKS,
    Finding,
    PlanVerificationError,
    PlanVerificationWarning,
    Report,
    VERIFY_ENV,
    VERIFY_MODES,
    clear_reports,
    counters,
    report_for,
    set_verify_mode,
    summarize_plan,
    verify_and_record,
    verify_mode,
    verify_plan,
)
from .launch_lint import (LINT_CHECKS, lint_plan, predicted_exchange_rounds,
                          predicted_launches)
from .serve_check import SHED_POLICIES, check_serve_config

__all__ = [
    "CHECKS", "LINT_CHECKS", "Finding", "PlanVerificationError",
    "PlanVerificationWarning", "Report", "VERIFY_ENV", "VERIFY_MODES",
    "SHED_POLICIES", "analyze_plan", "check_serve_config", "clear_reports",
    "counters", "lint_plan", "predicted_exchange_rounds",
    "predicted_launches", "report_for",
    "set_verify_mode", "summarize_plan", "verify_and_record", "verify_mode",
    "verify_plan",
]


def analyze_plan(plan, lint: bool = True) -> Report:
    """The full analysis of one plan: the invariant catalog (cached per
    plan) merged, when ``lint``, with the launch lint."""
    from .verify import _verify_cached
    report = _verify_cached(plan)
    if lint:
        report = report.merged(lint_plan(plan))
    return report
