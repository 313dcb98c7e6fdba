"""Carry the reference's inputs across to the port.

The port has no weights: its parameters are the stencil spec and the
grid.  :func:`spec_from_reference` rebuilds a ``repro_torch`` spec from
any object with ``name/ndim/taps/boundary/structure`` (a ``repro`` spec,
duck-typed — the JAX package is never imported), and
:func:`grid_from_numpy` puts a numpy grid on a device.  The parity tests
feed both packages the same inputs through these.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.stencil import StencilPipeline, StencilSpec


def spec_from_reference(obj) -> StencilSpec | StencilPipeline:
    """A ``repro_torch`` spec (or pipeline, for an object with
    ``stages``) equal in taps, boundary and structure to ``obj``."""
    if hasattr(obj, "stages"):
        return StencilPipeline(str(obj.name), tuple(
            spec_from_reference(s) for s in obj.stages))
    taps = tuple((tuple(int(o) for o in off), float(c))
                 for off, c in obj.taps)
    return StencilSpec(str(obj.name), int(obj.ndim), taps,
                       boundary=str(obj.boundary),
                       structure=str(obj.structure))


def grid_from_numpy(a, device="cpu") -> torch.Tensor:
    """A contiguous tensor copy of ``a`` on ``device``."""
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)
