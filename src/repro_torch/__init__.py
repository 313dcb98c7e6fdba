"""PyTorch/CUDA port of the Casper stencil reproduction.

Mirrors ``repro`` (``core/``, ``kernels/``, ``analysis/``, ``serve/``,
``models/``, ``configs/``): the same specs, oracle, plans, engine,
static verifier and stencil serving, with the TPU's Pallas kernels
replaced by CUDA kernels written for Hopper, and the transformer family
of language models served by ``serve.ServeEngine``.  Imports torch and
numpy only — never jax, never the ``repro`` package — and builds no
kernel at import time.
"""
from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all
from .convert import (config_from_reference, grid_from_numpy,
                      params_from_reference, request_from_reference,
                      serve_config_from_reference, spec_from_reference,
                      tensor_from_numpy)

__all__ = list(_core_all) + ["config_from_reference", "grid_from_numpy",
                             "params_from_reference",
                             "request_from_reference",
                             "serve_config_from_reference",
                             "spec_from_reference", "tensor_from_numpy"]
