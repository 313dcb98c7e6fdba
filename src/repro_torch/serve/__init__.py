"""Serving of the PyTorch port: stencils through the one-shot batched
server, the continuous-batching scheduler and the open-loop load
generator, and language models through :class:`ServeEngine`."""
from .engine import ServeEngine
from .stencil import (RequestError, ServeStats, StencilRequest,
                      StencilServer, default_specs)
from .scheduler import (AsyncStencilServer, RequestHandle, RequestRejected,
                        ServeConfig, bucket_tiers)
from .loadgen import (TimedRequest, mixed_requests, poisson_times,
                      poisson_workload, submit_open_loop)

__all__ = [
    "AsyncStencilServer", "RequestError", "RequestHandle",
    "RequestRejected", "ServeConfig", "ServeEngine", "ServeStats",
    "StencilRequest", "StencilServer", "TimedRequest", "bucket_tiers", "default_specs",
    "mixed_requests", "poisson_times", "poisson_workload",
    "submit_open_loop",
]
