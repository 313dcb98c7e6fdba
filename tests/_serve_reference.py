"""The reference's serving package for the port's parity tests.

``repro.serve`` imports ``jax.experimental.enable_x64``, which jax 0.9
no longer has.  :func:`jserve` aliases it to ``jax.enable_x64`` for one
test module and then puts the import state back (the alias and every
``repro.serve`` module), so the reference's own serving tests see the
package exactly as they would without the port's tests.  Nothing in
``repro`` changes.
"""
import importlib
import sys

import numpy as np
import pytest
import jax
import jax.experimental


@pytest.fixture(scope="module")
def jserve():
    """``repro.serve`` importable under jax 0.9 for this module, and the
    import state put back after it."""
    had = hasattr(jax.experimental, "enable_x64")
    before = {k for k in sys.modules if k.startswith("repro.serve")}
    saved = {k: sys.modules.pop(k) for k in before}
    jax.experimental.enable_x64 = jax.enable_x64
    try:
        yield importlib.import_module("repro.serve")
    finally:
        for k in [k for k in sys.modules if k.startswith("repro.serve")]:
            del sys.modules[k]
        sys.modules.update(saved)
        import repro
        if "repro.serve" in saved:
            repro.serve = saved["repro.serve"]
        elif hasattr(repro, "serve"):
            del repro.serve
        if not had:
            del jax.experimental.enable_x64


def reference_sequential(jserve, reqs, sweeps):
    """``repro``'s ``serve_sequential`` on ``backend="ref"`` in f64, as
    numpy arrays."""
    with jax.enable_x64(True):
        out, _ = jserve.StencilServer(backend="ref",
                                      sweeps=sweeps).serve_sequential(reqs)
        return [np.asarray(o) for o in out]
