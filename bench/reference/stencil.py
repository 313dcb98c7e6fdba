"""Plain PyTorch reference of one stencil configuration.

It imports torch alone: nothing of the program under test, nothing of
the JAX package.  Each application pads the grid by the stencil's halo
under the configuration's boundary, forms every tap's product and adds
it to an accumulator that starts at zero, in the order the taps are
listed.  That is the order in which the program sums a star or a dense
tap set, so in float64 the program's answer has to equal this one bit
for bit.  No fused multiply-add is used: a product and a sum are two
separate elementwise operations, each rounded.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F

_CONSTANT = re.compile(r"^constant\((?P<c>[^)]+)\)$")


def _pad(x: torch.Tensor, halo: list[int], boundary: str) -> torch.Tensor:
    """``x`` (trailing ``len(halo)`` dims are the grid) with ``halo[d]``
    ghost layers on each side of grid dim ``d``."""
    nd = len(halo)
    m = _CONSTANT.match(boundary)
    if boundary == "zero" or m:
        pads = []
        for h in reversed(halo):
            pads += [h, h]
        value = float(m.group("c")) if m else 0.0
        return F.pad(x, pads, mode="constant", value=value)
    out = x
    for d, h in enumerate(halo):
        axis = x.ndim - nd + d
        n = x.shape[axis]
        g = torch.arange(-h, n + h, device=x.device)
        if boundary == "periodic":
            idx = g % n
        elif boundary == "reflect":
            period = max(2 * n - 2, 1)
            m_ = g % period
            idx = torch.where(m_ < n, m_, period - m_) if n > 1 else g * 0
        else:
            raise ValueError(f"unknown boundary {boundary!r}")
        out = torch.index_select(out, axis, idx)
    return out


def apply(x: torch.Tensor, taps, boundary: str) -> torch.Tensor:
    """One application of ``taps`` (``[[offset, coefficient], ...]``) to
    ``x``; a leading batch dim rides along."""
    nd = len(taps[0][0])
    halo = [max(abs(off[d]) for off, _ in taps) for d in range(nd)]
    xp = _pad(x, halo, boundary)
    lead = x.ndim - nd
    acc = torch.zeros_like(x)
    for off, c in taps:
        index = [slice(None)] * lead + [
            slice(halo[d] + off[d], halo[d] + off[d] + x.shape[lead + d])
            for d in range(nd)]
        acc = acc + float(c) * xp[tuple(index)]
    return acc


def run(x: torch.Tensor, taps, boundary: str, iters: int,
        snapshots=()) -> torch.Tensor | dict[int, torch.Tensor]:
    """``iters`` applications to ``x``.  With ``snapshots`` (iteration
    counts up to ``iters``), a dict of the state after each of them,
    copied to the host."""
    want = set(int(s) for s in snapshots)
    kept = {}
    for i in range(1, iters + 1):
        x = apply(x, taps, boundary)
        if i in want:
            kept[i] = x.cpu()
    return kept if want else x
