"""Carry the reference's inputs across to the port.

The port has no weights: its parameters are the stencil spec and the
grid, and sliding-window attention's are its q/k/v.
:func:`spec_from_reference` rebuilds a ``repro_torch`` spec from any
object with ``name/ndim/taps/boundary/structure`` (a ``repro`` spec,
duck-typed — the JAX package is never imported), :func:`grid_from_numpy`
puts a numpy grid on a device and :func:`tensor_from_numpy` puts a numpy
array there in a given dtype.  The parity tests feed both packages the
same inputs through these.  For serving, :func:`request_from_reference`
and :func:`serve_config_from_reference` carry a reference request or
serving config across, duck-typed likewise.  For the language models,
:func:`params_from_reference` carries a parameter tree (the reference's
init as numpy arrays) and :func:`config_from_reference` a model config.
"""
from __future__ import annotations

import dataclasses

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


def tensor_from_numpy(a, dtype: torch.dtype, device="cpu") -> torch.Tensor:
    """A contiguous ``dtype`` tensor of ``a`` on ``device``.  The cast
    happens on the torch side; from an f32 array to bfloat16 it rounds to
    nearest even, as ``jnp.asarray(a, jnp.bfloat16)`` does."""
    return grid_from_numpy(a, device).to(dtype)


def request_from_reference(obj):
    """A ``repro_torch`` serving request equal to ``obj`` (an object with
    ``spec_name/grid/iters``; the grid becomes a numpy array)."""
    from .serve.stencil import StencilRequest
    return StencilRequest(str(obj.spec_name), np.asarray(obj.grid),
                          int(obj.iters))


def serve_config_from_reference(obj):
    """A ``repro_torch`` :class:`~repro_torch.serve.ServeConfig` with
    ``obj``'s fields.  Its ``x64`` is dropped: torch keeps float64 grids
    float64 without a switch."""
    from .serve.scheduler import ServeConfig
    return ServeConfig(**{f: getattr(obj, f) for f in (
        "max_bucket_size", "max_wait_s", "queue_depth",
        "default_deadline_s", "shed_policy", "pad_buckets")})


def params_from_reference(tree, *, device, dtype: torch.dtype | None = None):
    """The port's parameter tree from nested dicts (and tuples) of numpy
    arrays (the reference's parameters or states, ``np.asarray``'d), on
    ``device``; with ``dtype``, every floating leaf cast to it.  A
    bfloat16 array (numpy knows it only through ``ml_dtypes``) crosses as
    its bits."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, tuple):        # xLSTM's recurrent states
        return tuple(params_from_reference(v, device=device, dtype=dtype)
                     for v in tree)
    a = np.array(tree, order="C")        # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def config_from_reference(obj):
    """A ``repro_torch`` :class:`~repro_torch.models.ModelConfig` with
    ``obj``'s fields (its ``moe`` and ``ssm`` records likewise)."""
    from .models.config import ModelConfig, SsmCfg
    from .models.moe import MoeCfg

    def carry(cls, o):
        return cls(**{f.name: getattr(o, f.name)
                      for f in dataclasses.fields(cls)})

    fields = {f.name: getattr(obj, f.name)
              for f in dataclasses.fields(ModelConfig)}
    for name, cls in (("moe", MoeCfg), ("ssm", SsmCfg)):
        if fields[name] is not None:
            fields[name] = carry(cls, fields[name])
    return ModelConfig(**fields)
