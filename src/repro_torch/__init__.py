"""PyTorch/CUDA port of the Casper stencil reproduction.

Mirrors ``repro`` (``core/``, ``kernels/``, ``analysis/``, ``serve/``):
the same specs, oracle, plans, engine, static verifier and stencil
serving, with the TPU's Pallas kernels replaced by CUDA kernels
written for Hopper.  Imports torch and numpy only — never jax, never the
``repro`` package — and builds no kernel at import time.
"""
from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all
from .convert import (grid_from_numpy, request_from_reference,
                      serve_config_from_reference, spec_from_reference,
                      tensor_from_numpy)

__all__ = list(_core_all) + ["grid_from_numpy", "request_from_reference",
                             "serve_config_from_reference",
                             "spec_from_reference", "tensor_from_numpy"]
