"""Torch reference oracle for stencil application.

The port's counterpart of ``repro.core.ref``: the ground truth the
fused kernels' plain versions and the engine are held against, and
itself held bit for bit (f64) against the JAX oracle by
``tests/test_torch_ref.py``.

Every function works on the *trailing* ``ndim`` dims of its tensor, so
a leading batch dim rides along; window-local coordinates (``starts``,
``g0s``) may be ints or per-batch-element int64 tensors of shape
``(B,)`` when the tensor carries exactly one leading batch dim — that is
how the kernels' plain versions run every tile of a grid in one call.

Accumulation order is the one pinned by the JAX oracle: products are
formed first, then summed from zero in tap order (or in the factored
order of :func:`repro_torch.core.stencil.factor_taps`).  Torch runs
eagerly, so no compiler can regroup the chain; nothing here may use a
fused multiply-add (``torch.add(..., alpha=c)``, ``addcmul``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .stencil import (StencilSpec, _classify, as_stages, factor_taps,
                      parse_boundary)


def periodic_index(idx, n: int):
    """Wrap (possibly out-of-range) coordinates into ``[0, n)`` — the
    ghost→interior map of ``boundary="periodic"``.  Works on ints and
    integer tensors (``%`` takes the divisor's sign in both)."""
    return idx % n


def reflect_index(idx, n: int):
    """Fold (possibly out-of-range) coordinates into ``[0, n)`` by mirror
    reflection about the edge *elements* (period ``2n-2``, edge not
    repeated; a size-1 axis degenerates to index 0).  Works on ints,
    integer tensors and integer numpy arrays."""
    if n == 1:
        return idx * 0
    period = 2 * n - 2
    m = idx % period
    if isinstance(m, torch.Tensor):
        return torch.where(m < n, m, period - m)
    if isinstance(m, np.ndarray):
        return np.where(m < n, m, period - m)
    return m if m < n else period - m


def _coords(g0, ext: int, device) -> torch.Tensor:
    """Global coordinates ``g0 + [0, ext)``: shape ``(ext,)`` for an int
    ``g0``, ``(B, ext)`` for a ``(B,)`` tensor."""
    ar = torch.arange(ext, dtype=torch.int64, device=device)
    if isinstance(g0, torch.Tensor):
        return g0.to(device=device, dtype=torch.int64)[:, None] + ar
    return ar + int(g0)


def _along(c: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """View coordinates ``c`` (``(ext,)`` or ``(B, ext)``) so they
    broadcast along dim ``axis`` of ``x`` (and dim 0 for the batch)."""
    shape = [1] * x.ndim
    shape[axis] = c.shape[-1]
    if c.ndim == 2:
        shape[0] = c.shape[0]
    return c.reshape(shape)


def reflect_gather(x: torch.Tensor, axis: int, g0, n: int,
                   ext: int) -> torch.Tensor:
    """Overwrite ghosts along ``axis`` with their mirror source.

    ``x``'s extent ``ext`` along ``axis`` spans global coordinates
    ``[g0, g0+ext)`` of an ``n``-point grid axis; every element is
    replaced by the one at the fold of its own coordinate (identity for
    in-grid elements).  The clip only guards positions whose mirror lies
    outside the window, which no in-grid output ever reads.
    """
    g = _coords(g0, ext, x.device)
    start = g[..., :1]                  # g0 as a (1,) or (B, 1) tensor
    src = torch.clamp(reflect_index(g, n) - start, 0, ext - 1)
    if src.ndim == 1:
        return torch.index_select(x, axis, src)
    return torch.gather(x, axis, _along(src, x, axis).expand(x.shape))


def pad_boundary(grid: torch.Tensor, widths, mode: str = "zero",
                 value: float = 0.0) -> torch.Tensor:
    """Extend the trailing ``len(widths)`` dims of ``grid`` by
    ``widths[d]`` ghost layers per side according to ``mode``.

    Periodic and reflect ghosts are an index gather through
    :func:`periodic_index` / :func:`reflect_index` of each ghost's global
    coordinate, so they are bitwise copies of interior elements at any
    depth (``F.pad``'s circular/reflect modes stop at the grid's own
    size).  Zero/constant ghosts take the literal fill.
    """
    widths = [int(w) for w in widths]
    nd = len(widths)
    if mode in ("zero", "constant"):
        pads = []
        for w in reversed(widths):
            pads += [w, w]
        return F.pad(grid, pads, mode="constant",
                     value=float(value) if mode == "constant" else 0.0)
    if mode == "periodic":
        index = periodic_index
    elif mode == "reflect":
        index = reflect_index
    else:
        raise ValueError(f"unknown boundary mode {mode!r}")
    out = grid
    for d, w in enumerate(widths):
        axis = grid.ndim - nd + d
        n = grid.shape[axis]
        g = torch.arange(-w, n + w, dtype=torch.int64, device=grid.device)
        out = torch.index_select(out, axis, index(g, n))
    return out


def tap_sum(windows, coeffs, dtype) -> torch.Tensor:
    """``sum_k coeffs[k] * windows[k]`` in the pinned order: each product
    is formed, then added to an accumulator that starts at zero, in
    ``coeffs`` order.  The coefficient is converted to ``dtype`` as
    ``jnp.asarray(c, dtype)`` does (round to nearest)."""
    acc = torch.zeros(windows[0].shape, dtype=dtype,
                      device=windows[0].device)
    for c, w in zip(coeffs, windows):
        acc = acc + float(c) * w
    return acc


def tap_sum_numpy(windows, coeffs, dtype) -> np.ndarray:
    """Numpy analogue of :func:`tap_sum` (independent of torch): products
    added from zero in ``coeffs`` order, bit-equal to it in f64."""
    dtype = np.dtype(dtype)
    acc = np.zeros(windows[0].shape, dtype)
    for c, w in zip(coeffs, windows):
        acc = acc + dtype.type(c) * w
    return acc


def _slice(x, starts, sizes):
    """The trailing-dims block ``x[..., s:s+n, ...]`` (a tensor or an
    array)."""
    return x[(Ellipsis,) + tuple(slice(s, s + n)
                                 for s, n in zip(starts, sizes))]


def factored_window_apply(x, terms, halo, out_shape, dtype, *,
                          tsum=tap_sum):
    """One structure-specialized application of a factored tap set to
    window ``x`` (trailing shape ``out_shape + 2*halo``).

    Each term runs as sequential 1-D axis passes: a pass consumes its
    factor's radius along its axis and trims every axis that carries no
    later factor down to the interior.  Every pass and the final
    term-sum go through ``tsum`` (:func:`tap_sum`, or
    :func:`tap_sum_numpy` on an array); a single term is returned as
    is — the order of ``repro.core.ref.factored_window_apply``.
    """
    ndim = len(out_shape)
    vals = []
    for term in terms:
        radius = {f.axis: f.radius for f in term.factors}
        org = [-h for h in halo]                # window coord of y's origin
        y = x
        pending = [f.axis for f in term.factors]
        for f in term.factors:
            pending = pending[1:]               # axes with later factors
            new_org = [-(radius[d] if d in pending else 0)
                       for d in range(ndim)]
            ext = [n - 2 * o for n, o in zip(out_shape, new_org)]
            wins = []
            for off in f.offsets:
                starts = [new_org[d] - org[d] + (off if d == f.axis else 0)
                          for d in range(ndim)]
                wins.append(_slice(y, starts, ext))
            y = tsum(wins, f.coeffs, dtype)
            org = new_org
        vals.append(y)
    if len(vals) == 1:
        return vals[0]
    return tsum(vals, (1.0,) * len(vals), dtype)


def _window_apply(x, taps, halo, cur, acc_dtype, terms) -> torch.Tensor:
    """One stencil application on window ``x``: the taps slice ``halo``
    layers off per side, producing trailing shape ``cur``."""
    if terms is not None:
        return factored_window_apply(x, terms, halo, cur, acc_dtype)
    return tap_sum(
        [_slice(x, [h + o for h, o in zip(halo, off)], cur)
         for off, _ in taps],
        [c for _, c in taps], acc_dtype)


def _restore_ghosts(acc, mode, value, g0s, grid_shape, cur) -> torch.Tensor:
    """Restore boundary ghosts of an intermediate window ``acc`` whose
    dim-``d`` extent spans global coordinates ``[g0s[d], g0s[d]+cur[d])``
    of a ``grid_shape`` grid:

    * ``zero`` / ``constant``: out-of-grid positions take the fill value;
    * ``reflect``: out-of-grid positions re-mirror from the interior,
      one axis at a time;
    * ``periodic``: nothing — periodic ghosts evolve correctly on their
      own.
    """
    ndim = len(cur)
    lead = acc.ndim - ndim
    if mode in ("zero", "constant"):
        valid = None
        for d in range(ndim):
            g = _coords(g0s[d], cur[d], acc.device)
            vd = _along((g >= 0) & (g < grid_shape[d]), acc, lead + d)
            valid = vd if valid is None else valid & vd
        fill = float(value) if mode == "constant" else 0.0
        return torch.where(valid, acc, fill)
    if mode == "reflect":
        for d in range(ndim):
            acc = reflect_gather(acc, lead + d, g0s[d], grid_shape[d],
                                 cur[d])
        return acc
    if mode != "periodic":
        raise ValueError(f"unknown boundary mode {mode!r}")
    return acc


def masked_window_sweeps(window: torch.Tensor, taps, halo, out_shape,
                         sweeps: int, starts, grid_shape, acc_dtype, *,
                         mode: str = "zero", value: float = 0.0,
                         structure: str = "auto") -> torch.Tensor:
    """Apply ``sweeps`` fused stencil applications to one widened window
    (or a leading batch of them).

    ``window`` carries ``sweeps`` halo layers per side around an
    ``out_shape`` interior whose origin sits at global coordinate
    ``starts`` of a ``grid_shape`` grid; application ``s`` consumes one
    layer.  Between applications, ghosts (by *global* coordinate) are
    restored by :func:`_restore_ghosts`.  Compute dispatches on
    ``structure`` exactly as ``repro.core.ref.masked_window_sweeps``
    does: separable specs run the factored passes, star and dense specs
    the tap chain (``"dense"`` forces it).  This is the shared core of
    the plain versions of kernels K1 and K2.
    """
    ndim = len(out_shape)
    terms = (None if structure == "dense"
             else _classify(ndim, tuple(taps)).compute_terms)
    x = window.to(acc_dtype)
    for s in range(sweeps):
        rem = sweeps - 1 - s          # halo layers left after this sweep
        cur = tuple(t + 2 * rem * h for t, h in zip(out_shape, halo))
        acc = _window_apply(x, taps, halo, cur, acc_dtype, terms)
        if rem:
            g0s = tuple(starts[d] - rem * halo[d] for d in range(ndim))
            acc = _restore_ghosts(acc, mode, value, g0s, grid_shape, cur)
        x = acc
    return x


def masked_window_pipeline(window: torch.Tensor, stages, out_shape,
                           sweeps: int, starts, grid_shape,
                           acc_dtype) -> torch.Tensor:
    """Apply ``sweeps`` fused applications of a stage chain to one
    widened window (or a leading batch of them) — the pipeline form of
    :func:`masked_window_sweeps`, as
    ``repro.core.ref.masked_window_pipeline``.

    ``window`` carries ``sweeps * H`` ghost layers per side (``H`` the
    per-dim sum of the stage radii) holding stage 0's boundary
    extension.  Each stage application consumes its own radius; after
    every application but the last, the ghosts left are restored to the
    extension of the *next* stage to run, ``stages[(k+1) % n]``, at
    ``g0 = starts - rem`` where ``rem`` is the ghost depth the rest of
    the block still consumes.  This is the shared core of the plain
    versions of kernels K3 and K4.
    """
    ndim = len(out_shape)
    stages = tuple(stages)
    n = len(stages)
    total = sweeps * n
    rem = tuple(sweeps * sum(s.halo[d] for s in stages)
                for d in range(ndim))
    x = window.to(acc_dtype)
    step = 0
    for _ in range(sweeps):
        for k, stage in enumerate(stages):
            halo = stage.halo
            rem = tuple(r - h for r, h in zip(rem, halo))
            cur = tuple(t + 2 * r for t, r in zip(out_shape, rem))
            terms = (None if stage.structure == "dense"
                     else _classify(ndim, stage.taps).compute_terms)
            acc = _window_apply(x, stage.taps, halo, cur, acc_dtype, terms)
            step += 1
            if step < total:
                nxt = stages[(k + 1) % n]
                g0s = tuple(starts[d] - rem[d] for d in range(ndim))
                acc = _restore_ghosts(acc, nxt.boundary_mode,
                                      nxt.boundary_value, g0s, grid_shape,
                                      cur)
            x = acc
    return x


def apply_pipeline(pipeline, grid: torch.Tensor) -> torch.Tensor:
    """One application of a stage chain (a ``StencilPipeline`` or any
    sequence of specs): each stage one :func:`apply_stencil` sweep under
    its own boundary mode — the chained oracle of the fused pipelines."""
    for stage in (pipeline.stages if hasattr(pipeline, "stages")
                  else tuple(pipeline)):
        grid = apply_stencil(stage, grid)
    return grid


def run_pipeline(pipeline, grid: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` chained applications of the full stage chain."""
    for _ in range(iters):
        grid = apply_pipeline(pipeline, grid)
    return grid


def apply_stencil(spec: StencilSpec, grid: torch.Tensor) -> torch.Tensor:
    """``out[p] = sum_k c_k * in[p + off_k]``, one sweep over the
    trailing ``spec.ndim`` dims; taps past the edge are served by
    ``spec.boundary`` and compute dispatches on ``spec.structure``."""
    if grid.ndim not in (spec.ndim, spec.ndim + 1):
        raise ValueError(f"grid rank {grid.ndim} != spec ndim {spec.ndim}")
    halo = spec.halo
    shape = tuple(grid.shape[grid.ndim - spec.ndim:])
    padded = pad_boundary(grid, halo, spec.boundary_mode,
                          spec.boundary_value)
    terms = factor_taps(spec).compute_terms
    if terms is not None:
        return factored_window_apply(padded, terms, halo, shape, grid.dtype)
    windows = [_slice(padded, [h + o for h, o in zip(halo, off)], shape)
               for off, _ in spec.taps]
    return tap_sum(windows, spec.coeffs, grid.dtype)


def pad_boundary_numpy(grid: np.ndarray, widths, mode: str = "zero",
                       value: float = 0.0) -> np.ndarray:
    """Numpy analogue of :func:`pad_boundary` (``np.pad``; wrap repeats
    and reflect folds at any depth, as the index gathers do)."""
    pad = [(int(w), int(w)) for w in widths]
    if mode == "zero":
        return np.pad(grid, pad)
    if mode == "constant":
        return np.pad(grid, pad, constant_values=value)
    if mode == "periodic":
        return np.pad(grid, pad, mode="wrap")
    if mode == "reflect":
        return np.pad(grid, pad, mode="reflect")
    raise ValueError(f"unknown boundary mode {mode!r}")


def apply_stencil_numpy(spec: StencilSpec, grid: np.ndarray) -> np.ndarray:
    """Loop-free numpy oracle (independent of torch): dispatches on
    ``spec.structure`` as :func:`apply_stencil` does and walks the same
    factored order, so the two are bit-equal in f64."""
    halo = spec.halo
    padded = pad_boundary_numpy(grid, halo, spec.boundary_mode,
                                spec.boundary_value)
    terms = factor_taps(spec).compute_terms
    if terms is not None:
        return factored_window_apply(padded, terms, halo, grid.shape,
                                     grid.dtype, tsum=tap_sum_numpy)
    out = np.zeros_like(grid)
    for off, coeff in spec.taps:
        out = out + coeff * _slice(padded, [h + o for h, o in zip(halo, off)],
                                   grid.shape)
    return out


def apply_stencil_loops(spec: StencilSpec, grid: np.ndarray) -> np.ndarray:
    """Scalar loop oracle (the paper's Fig. 2 pseudo-code), slow: for
    tiny grids in tests only.  Out-of-grid taps are served point by point
    from the spec's boundary mode, the most literal statement of the
    semantics."""
    mode, value = parse_boundary(spec.boundary)
    out = np.zeros_like(grid)
    shape = grid.shape
    for p in np.ndindex(*shape):
        acc = 0.0
        for off, coeff in spec.taps:
            q = tuple(pi + oi for pi, oi in zip(p, off))
            if all(0 <= qi < ni for qi, ni in zip(q, shape)):
                acc += coeff * grid[q]
            elif mode == "constant":
                acc += coeff * value
            elif mode == "periodic":
                acc += coeff * grid[tuple(periodic_index(qi, ni)
                                          for qi, ni in zip(q, shape))]
            elif mode == "reflect":
                acc += coeff * grid[tuple(reflect_index(qi, ni)
                                          for qi, ni in zip(q, shape))]
            # zero: out-of-grid taps add nothing
        out[p] = acc
    return out


def run_iterations(spec: StencilSpec, grid: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """Jacobi time-stepping: out-of-place sweep, swap, repeat."""
    out = grid
    for _ in range(iters):
        out = apply_stencil(spec, out)
    return out


def execute_plan(plan, grid: torch.Tensor) -> torch.Tensor:
    """``ref``-backend executor of one lowered plan: ``plan.sweeps``
    chained oracle applications of the plan's stage chain (ghost
    strategy ``"pad"``)."""
    if plan.backend != "ref":
        raise ValueError(f"not a ref plan: backend={plan.backend!r}")
    out = grid
    for _ in range(plan.sweeps):
        for stage in as_stages(plan.spec):
            out = apply_stencil(stage, out)
    return out
