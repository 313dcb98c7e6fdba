"""The port's spans, on ``torch.profiler``'s timeline.

``span(name)`` is a range of the profiler's own record function while
a ``torch.profiler`` session records in this process, and one shared
no-op context manager otherwise: an untraced run pays a function call
and a flag read per span, with no allocation and no torch call.  The
profiler is the only store and exporter, so the spans land in its trace
beside the device's kernels, on the same clock (as host events of the
``cpu_op`` category).

The range is the C++ ``_RecordFunctionFast``, not
``torch.profiler.record_function``: the latter enters and leaves through
two dispatcher operators, which while recording cost several times more
per span, and that cost lands inside the spans around it.

The spans of the solve path (``name``: what it covers):

* ``casper.run``: one ``CasperEngine.run`` (``plan.runner``): placement
  and the whole block loop;
* ``casper.place``: the plan looked up or lowered, the grid moved to the
  device, contiguous (``plan.place``);
* ``casper.block``: one fused block's host work, its launch included
  (each ``plan.execute`` of ``plan.run_owned``, the remainder too);
* ``casper.launch``: one K1-K4 launch (``kernels.engine._launch``): pack
  factor, load path, argument packing, the call into the library;
* ``casper.lower``: a plan cache miss (``PlanCache.get_or_lower``):
  lowering, autotune and verification;
* ``casper.verify``: the new plan's static verification.
"""
from __future__ import annotations

import contextlib

from torch._C import _profiler as _cprofiler
from torch.autograd import profiler as _profiler

#: What :func:`span` returns while no profiler records (reusable).
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``name`` while a ``torch.profiler`` session
    records, else a shared no-op context manager."""
    if _profiler._is_profiler_enabled:
        return _cprofiler._RecordFunctionFast(name)
    return _OFF
