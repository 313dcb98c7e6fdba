"""CPU mirror of the pad-free stencil kernel's tile logic (``csrc/stencil.cu``).

The kernel splits its tiles into two kinds, uniformly per CTA:

* **interior**: the whole widened window
  ``[origin - sweeps*H, origin + tile + sweeps*H)`` lies inside the grid
  in every dim, so the window is a plain copy (no boundary index map) and
  no intermediate is restored;
* **rim**: the window is gathered through stage 0's boundary index map and,
  after every application but the last, only the ghost rim is restored
  in the next stage's mode: for reflect, one axis at a time, the two slabs
  of positions whose coordinate along that axis leaves the grid copy the
  clipped fold of it; for zero/constant, positions with an out-of-grid
  coordinate take the fill; for periodic, nothing.

This module walks the same decisions in torch (numpy-free, no JAX), one
tile at a time, with the arithmetic of ``repro_torch.core.ref`` (tap or
factored order), so the tests can hold the design against the reference
on the CPU, where the kernel cannot run.
"""
import itertools

import torch

from repro_torch.core import ref as tref
from repro_torch.core.stencil import _classify, as_stages


def tile_origins(shape, tile):
    """The origin of every tile of a ``shape`` grid, dim 0 slowest."""
    return itertools.product(*[range(0, n, t) for n, t in zip(shape, tile)])


def is_interior(origin, tile, deep, shape) -> bool:
    """The kernel's classification: the tile's window, ``deep`` layers
    per side, lies inside the grid in every dim."""
    return all(o - w >= 0 and o + t + w <= n
               for o, t, w, n in zip(origin, tile, deep, shape))


def window_coords(origin, tile, deep):
    """Per dim, the global coordinates the tile's window spans."""
    return [range(o - w, o + t + w) for o, t, w in zip(origin, tile, deep)]


def restore_rim(acc, mode, value, g0s, grid_shape, cur):
    """The kernel's restoration of one intermediate: ``acc``'s trailing
    dims have extents ``cur`` and start at global coordinates ``g0s`` of
    a ``grid_shape`` grid.  Only out-of-grid positions are written."""
    nd = len(cur)
    lead = acc.ndim - nd
    acc = acc.clone()
    if mode in ("zero", "constant"):
        outside = torch.zeros(acc.shape[lead:], dtype=torch.bool)
        for d in range(nd):
            g = torch.arange(cur[d]) + g0s[d]
            shape = [1] * nd
            shape[d] = cur[d]
            outside |= ((g < 0) | (g >= grid_shape[d])).reshape(shape)
        acc[(Ellipsis,) + (outside,)] = float(value) if mode == "constant" \
            else 0.0
        return acc
    if mode == "periodic":
        return acc
    for d in range(nd):
        n, g0, c = grid_shape[d], g0s[d], cur[d]
        lo = min(max(-g0, 0), c)
        hi = min(max(g0 + c - n, 0), c - lo)
        if lo + hi == 0:
            continue
        ghosts = list(range(lo)) + list(range(c - hi, c))
        src = [min(max(tref.reflect_index(g0 + q, n) - g0, 0), c - 1)
               for q in ghosts]
        vals = acc.index_select(lead + d, torch.tensor(src))
        acc.index_copy_(lead + d, torch.tensor(ghosts), vals)
    return acc


def _gather_window(grid, origin, tile, deep, mode, value):
    """A rim tile's window through stage 0's boundary index map."""
    idx, valid = [], []
    for d, (o, t, w) in enumerate(zip(origin, tile, deep)):
        n = grid.shape[d]
        g = torch.arange(o - w, o + t + w)
        if mode == "periodic":
            idx.append(tref.periodic_index(g, n))
        elif mode == "reflect":
            idx.append(tref.reflect_index(g, n))
        else:
            idx.append(g.clamp(0, n - 1))
            shape = [1] * len(tile)
            shape[d] = len(g)
            valid.append(((g >= 0) & (g < n)).reshape(shape))
    win = grid[torch.meshgrid(*idx, indexing="ij")]
    for v in valid:
        win = torch.where(v, win, float(value) if mode == "constant" else 0.0)
    return win


def fused_block(spec, grid, tile, sweeps):
    """One fused block of ``sweeps`` applications of ``spec`` (a spec or
    a fusable pipeline) on an unpadded grid, tile by tile as the pad-free
    kernel runs it.  Returns ``(out, n_interior, n_rim)``."""
    stages = as_stages(spec)
    nd = spec.ndim
    deep = tuple(sweeps * h for h in spec.halo)
    shape = tuple(grid.shape)
    out = torch.empty_like(grid)
    n_int = n_rim = 0
    total = sweeps * len(stages)
    for origin in tile_origins(shape, tile):
        interior = is_interior(origin, tile, deep, shape)
        if interior:
            n_int += 1
            x = grid[tuple(slice(o - w, o + t + w)
                           for o, t, w in zip(origin, tile, deep))]
        else:
            n_rim += 1
            x = _gather_window(grid, origin, tile, deep,
                               stages[0].boundary_mode,
                               stages[0].boundary_value)
        rem = list(deep)
        step = 0
        for _ in range(sweeps):
            for k, st in enumerate(stages):
                rem = [r - h for r, h in zip(rem, st.halo)]
                cur = tuple(t + 2 * r for t, r in zip(tile, rem))
                terms = (None if st.structure == "dense"
                         else _classify(nd, st.taps).compute_terms)
                x = tref._window_apply(x, st.taps, st.halo, cur, grid.dtype,
                                       terms)
                step += 1
                if step < total and not interior:
                    nxt = stages[(k + 1) % len(stages)]
                    x = restore_rim(x, nxt.boundary_mode, nxt.boundary_value,
                                    [o - r for o, r in zip(origin, rem)],
                                    shape, cur)
        keep = tuple(slice(0, min(t, n - o))
                     for o, t, n in zip(origin, tile, shape))
        out[tuple(slice(o, o + k.stop) for o, k in zip(origin, keep))] = x[keep]
    return out, n_int, n_rim
