"""DEPRECATED oracle shim module, as ``repro.kernels.ref``.

The stencil oracle lives in :mod:`repro_torch.core.ref`
(``apply_stencil``), the windowed-attention oracle beside its kernel in
:mod:`repro_torch.kernels.swa` (``swa_ref``).  The old names resolve
lazily through the aliases below and emit ``DeprecationWarning``.
"""
from __future__ import annotations

import importlib
import warnings

_ALIASES = {
    "stencil_ref": ("repro_torch.core.ref", "apply_stencil"),
    "swa_ref": ("repro_torch.kernels.swa", "swa_ref"),
    "StencilSpec": ("repro_torch.core.stencil", "StencilSpec"),
}


def __getattr__(name: str):
    if name in _ALIASES:
        module, attr = _ALIASES[name]
        warnings.warn(
            f"repro_torch.kernels.ref.{name} is deprecated; use "
            f"{module}.{attr} (the oracle shim module was folded into the "
            "plan-driven entry points)", DeprecationWarning, stacklevel=2)
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(_ALIASES)
