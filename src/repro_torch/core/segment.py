"""Stencil segment & LLC slice mapping model (paper §4.2).

A numpy-only copy of ``repro.core.segment`` for the PyTorch port (the
engine's ``SegmentConfig``).

Casper replaces the CPU's undisclosed line-interleaved slice hash with a
*linear block hash* inside the stencil segment: contiguous 128 kB blocks map
to LLC slices round-robin, so neighboring grid points live in the same slice
and remote (NoC) traffic only occurs at block boundaries.

This module models both mappings and counts local vs. remote input loads for
any stencil/grid, which drives:
  * the Fig. 14 ablation benchmark (custom mapping vs. baseline mapping),
  * the remote-access penalty of the performance model,
  * the choice of shard block shapes in the distributed (`halo.py`) runtime —
    a device shard is the TPU analogue of a slice-local block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np

from .stencil import StencilSpec

ELEM_BYTES = 8          # double precision, as in the paper
LINE_BYTES = 64         # cache line
DEFAULT_BLOCK_BYTES = 128 * 1024   # the paper's chosen block size (§4.2)

Mapping = Literal["blocked", "striped"]


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    n_slices: int = 16
    mapping: Mapping = "blocked"
    block_bytes: int = DEFAULT_BLOCK_BYTES

    @property
    def block_elems(self) -> int:
        return self.block_bytes // ELEM_BYTES

    @property
    def line_elems(self) -> int:
        return LINE_BYTES // ELEM_BYTES

    def slice_of(self, elem_index: np.ndarray) -> np.ndarray:
        """LLC slice id for a (vector of) element index(es) in the segment."""
        if self.mapping == "blocked":
            return (elem_index // self.block_elems) % self.n_slices
        # baseline: consecutive cache lines round-robin across slices [158]
        return (elem_index // self.line_elems) % self.n_slices


def _flat_strides(shape: tuple[int, ...]) -> tuple[int, ...]:
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    return tuple(strides)


def access_counts(
    spec: StencilSpec,
    shape: tuple[int, ...],
    cfg: SegmentConfig,
    sample_cap: int = 1 << 22,
) -> dict[str, float]:
    """Count local/remote input loads for one sweep.

    Each SPU computes the points whose *output* maps to its slice (Casper
    assigns work by data placement).  An input load is *remote* when the tap's
    address maps to a different slice than the output point's slice.

    Grids larger than ``sample_cap`` points are sampled with a stride that
    preserves position-within-block distribution (exact for the paper sizes).
    """
    n = math.prod(shape)
    strides = _flat_strides(shape)

    if n > sample_cap:
        step = -(-n // sample_cap)
        idx = np.arange(0, n, step, dtype=np.int64)
    else:
        idx = np.arange(n, dtype=np.int64)

    # Un-flatten to coordinates to handle row-boundary wraps exactly.
    coords = []
    rem = idx
    for d, s in enumerate(strides):
        coords.append(rem // s)
        rem = rem % s

    out_slice = cfg.slice_of(idx)
    local = np.int64(0)
    remote = np.int64(0)
    for off, _ in spec.taps:
        valid = np.ones(idx.shape, dtype=bool)
        flat = np.zeros_like(idx)
        for d, (o, s) in enumerate(zip(off, strides)):
            c = coords[d] + o
            valid &= (c >= 0) & (c < shape[d])
            flat += c * s
        in_slice = cfg.slice_of(np.where(valid, flat, 0))
        is_local = (in_slice == out_slice) & valid
        local += int(np.count_nonzero(is_local))
        remote += int(np.count_nonzero(valid & ~is_local))

    total = local + remote
    scale = n / len(idx)
    return {
        "local": float(local) * scale,
        "remote": float(remote) * scale,
        "total": float(total) * scale,
        "remote_fraction": float(remote) / float(total) if total else 0.0,
    }


def remote_fraction(spec: StencilSpec, shape: tuple[int, ...],
                    cfg: SegmentConfig) -> float:
    return access_counts(spec, shape, cfg)["remote_fraction"]


def spu_assignment(shape: tuple[int, ...], cfg: SegmentConfig) -> np.ndarray:
    """Output-point -> SPU map (SPU id == slice id of the output address)."""
    n = math.prod(shape)
    return cfg.slice_of(np.arange(n, dtype=np.int64)).reshape(shape)
