"""Stencil serving of the PyTorch port: the one-shot batched server, the
continuous-batching scheduler and the open-loop load generator.  The
reference's ``ServeEngine`` serves its language models and belongs with
them (ROADMAP Queue 1 item 13)."""
from .stencil import (RequestError, ServeStats, StencilRequest,
                      StencilServer, default_specs)
from .scheduler import (AsyncStencilServer, RequestHandle, RequestRejected,
                        ServeConfig, bucket_tiers)
from .loadgen import (TimedRequest, mixed_requests, poisson_times,
                      poisson_workload, submit_open_loop)

__all__ = [
    "AsyncStencilServer", "RequestError", "RequestHandle",
    "RequestRejected", "ServeConfig", "ServeStats", "StencilRequest",
    "StencilServer", "TimedRequest", "bucket_tiers", "default_specs",
    "mixed_requests", "poisson_times", "poisson_workload",
    "submit_open_loop",
]
