"""The Hopper constants that lowering reads.

Only the budgets :func:`repro_torch.core.plan.lower` and the kernel
wrappers' launch geometry consult are ported here; the Casper/CPU/GPU analytic model of
``repro.core.perfmodel`` (Tables 4-6) waits for ROADMAP Queue 1 item 11,
and the tile cost model for item 6.
"""
from __future__ import annotations

import os

#: H100 SXM device memory, 80 GB (NVIDIA H100 data sheet).  A grid larger
#: than this (or than ``CASPER_SLAB_BUDGET``) would need out-of-core slab
#: streaming, which the port does not have yet (ROADMAP Queue 1 item 7).
H100_HBM_BYTES = 80 * 10 ** 9

#: H100 SXM HBM3 bandwidth, 3.35 TB/s (NVIDIA H100 data sheet).
H100_HBM_BW = 3.35e12

#: H100 L2 cache, 50 MB (NVIDIA Hopper architecture white paper).
H100_L2_BYTES = 50 * 10 ** 6

#: Largest dynamic shared memory one block may opt into on Hopper:
#: 227 KB = 232,448 bytes (CUDA C++ programming guide, compute
#: capability 9.0).  The fused kernels' two window buffers must fit it.
H100_SMEM_PER_BLOCK = 232448

#: H100 SXM streaming multiprocessors (NVIDIA H100 data sheet).
H100_SMS = 132

#: Shared memory of one H100 SM that blocks can share: 228 KB = 233,472
#: bytes, of which the system reserves 1 KB per resident block (CUDA C++
#: programming guide, compute capability 9.0).
H100_SMEM_PER_SM = 233472
H100_SMEM_RESERVED_PER_BLOCK = 1024

#: Whole-grid budget of the periodic pad-free decision: periodic grids
#: above it take the padded-window kernel (K2) and its host pad.  The
#: reference sized it as a quarter of the fast memory the grid must sit
#: in (``perfmodel.py:248``: L2 // 4 on the GPU path), because a Pallas
#: block held the whole grid.  K1 reads periodic ghosts from device
#: memory through the boundary index map, so no such limit binds it, and
#: on the H100 K1 beat K2 plus the pad at every periodic size measured
#: (``tools/rank3_probe.py``; PERF.md): the budget is the whole device
#: memory, above which the plan streams from the host anyway.
PERIODIC_WHOLE_GRID_BYTES = H100_HBM_BYTES

#: Environment override for the slab budget (bytes); part of the plan
#: cache key, as in the reference.
SLAB_BUDGET_ENV = "CASPER_SLAB_BUDGET"


def slab_budget_bytes() -> int:
    """The device-memory budget for whole-grid residency:
    :data:`H100_HBM_BYTES` unless ``CASPER_SLAB_BUDGET`` overrides it."""
    raw = os.environ.get(SLAB_BUDGET_ENV)
    if raw is None:
        return H100_HBM_BYTES
    budget = int(raw)
    if budget < 1:
        raise ValueError(f"{SLAB_BUDGET_ENV} must be >= 1 byte, got {raw!r}")
    return budget
