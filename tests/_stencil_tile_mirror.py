"""CPU mirror of the stencil kernels' tile logic (``csrc/stencil.cu``).

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
on the CPU, where the kernel cannot run.  :func:`window_kernel_block`
walks the window kernel's CTAs on both entries at the level of its shared
memory: fitted tiles, several grids per CTA, linear tap offsets.
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


# ---------------------------------------------------------------------------
# Rank 3, one stage: the streaming order (planes along the slow axis)
# ---------------------------------------------------------------------------
#: Planes the kernel loads ahead of the plane it reads
#: (``CASPER_STREAM_AHEAD`` in ``csrc/stencil.cu``).
STREAM_AHEAD = 2


def stream_ring_depths(spec):
    """Planes each level's ring holds, as the kernel allocates them: the
    ``2*h0 + 1`` planes the next application reads (``h0`` the radius
    along dim 0) and, for the window (level 0), the planes in flight, for
    an intermediate the plane formed while those are read."""
    r = 2 * spec.halo[0] + 1
    return r + STREAM_AHEAD, r + 1


class _Ring:
    """A ring of planes keyed by global coordinate ``z mod depth``; a
    read asserts that the slot still holds plane ``z`` (what the kernel
    relies on without checking)."""

    def __init__(self, depth):
        self.depth, self.slots = depth, {}

    def put(self, z, plane):
        self.slots[z % self.depth] = (z, plane)

    def get(self, z):
        held, plane = self.slots[z % self.depth]
        assert held == z, f"ring slot holds plane {held}, read {z}"
        return plane


def stream_block(spec, src, tile, sweeps, *, origin=None, grid_shape=None,
                 out_shape=None):
    """One fused block of ``sweeps`` applications of a rank-3 spec as the
    streaming kernel runs it, tile by tile (a tile is a z chunk of an xy
    tile).  ``src`` is the unpadded grid (K1), or with ``origin`` and
    ``grid_shape`` a window pre-padded by ``sweeps*halo`` whose interior
    ``out_shape`` sits at ``origin`` of the global grid (K2).

    Each tile walks its planes along dim 0: a step loads one plane of the
    window into level 0's ring (``STREAM_AHEAD`` planes ahead of the one
    it reads) and advances every application by one plane, level 1
    forming the plane ``h0`` behind the newest window plane and every
    later level the plane ``h0 + 1`` behind its predecessor's, from the
    ``2*h0 + 1`` planes of level ``l - 1`` around it, so that a step reads
    only planes formed at earlier steps (the levels run here from the
    last to the first, and a ring read of a plane not yet formed fails);
    the last level writes the output.  Out-of-grid planes of an
    intermediate take the
    fill (zero/constant), are formed like any other (periodic), or are
    never formed (reflect): a read of one goes to its mirror plane, which
    the ring holds for every in-grid reader.  Within a plane, the ghosts
    of a rim tile are restored along dim 1, then dim 2, as
    :func:`restore_rim` does.  Returns ``(out, n_interior, n_rim)``."""
    padded = origin is not None
    h = spec.halo
    s_ = sweeps
    mode, value = spec.boundary_mode, spec.boundary_value
    fill = float(value) if mode == "constant" else 0.0
    grid_shape = tuple(grid_shape or src.shape)
    out_shape = tuple(out_shape or src.shape)
    origin = tuple(origin or (0, 0, 0))
    terms = (None if spec.structure == "dense"
             else _classify(3, spec.taps).compute_terms)
    depth0, depth = stream_ring_depths(spec)
    out = torch.empty(out_shape, dtype=src.dtype)
    n_int = n_rim = 0
    for base in tile_origins(out_shape, tile):
        nz = min(tile[0], out_shape[0] - base[0])
        g0 = [o + b for o, b in zip(origin, base)]
        xy_in = all(g0[d] - s_ * h[d] >= 0
                    and g0[d] + tile[d] + s_ * h[d] <= grid_shape[d]
                    for d in (1, 2))
        interior = xy_in and g0[0] - s_ * h[0] >= 0 \
            and g0[0] + nz + s_ * h[0] <= grid_shape[0]
        n_int += interior
        n_rim += not interior
        rings = [_Ring(depth0)] + [_Ring(depth) for _ in range(s_ - 1)]

        def load(z):
            """Level 0's plane ``z``: the window's rows and columns of the
            tile, through the boundary index map (K1) or from the
            pre-padded window, zero past its end (K2)."""
            ys = torch.arange(g0[1] - s_ * h[1], g0[1] + tile[1] + s_ * h[1])
            xs = torch.arange(g0[2] - s_ * h[2], g0[2] + tile[2] + s_ * h[2])
            if padded:
                loc = [z - origin[0] + s_ * h[0], ys - origin[1] + s_ * h[1],
                       xs - origin[2] + s_ * h[2]]
                ok = [torch.as_tensor(c < n) for c, n in zip(loc, src.shape)]
                idx = [torch.as_tensor(c).clamp(max=n - 1)
                       for c, n in zip(loc, src.shape)]
                plane = src[idx[0]][idx[1][:, None], idx[2][None]]
                return torch.where(ok[0] & ok[1][:, None] & ok[2][None],
                                   plane, 0.0)
            coords = [torch.as_tensor(z), ys, xs]
            if mode == "periodic":
                idx = [tref.periodic_index(c, n)
                       for c, n in zip(coords, grid_shape)]
                ok = None
            elif mode == "reflect":
                idx = [tref.reflect_index(c, n)
                       for c, n in zip(coords, grid_shape)]
                ok = None
            else:
                idx = [c.clamp(0, n - 1) for c, n in zip(coords, grid_shape)]
                ok = [(c >= 0) & (c < n) for c, n in zip(coords, grid_shape)]
            plane = src[idx[0]][idx[1][:, None], idx[2][None]]
            if ok is not None:
                plane = torch.where(ok[0] & ok[1][:, None] & ok[2][None],
                                    plane, fill)
            return plane

        def read(level, z):
            """Plane ``z`` of ``level``: a reflect intermediate's
            out-of-grid plane is its mirror plane."""
            if level and mode == "reflect" and not 0 <= z < grid_shape[0]:
                z = tref.reflect_index(z, grid_shape[0])
            return rings[level].get(z)

        z_first = g0[0] - s_ * h[0]
        planes0 = nz + 2 * s_ * h[0]
        for p in range(min(STREAM_AHEAD, planes0)):
            rings[0].put(z_first + p, load(z_first + p))
        for j in range(planes0 + s_ - 1):
            if j + STREAM_AHEAD < planes0:      # issued ahead of its use
                zp = z_first + j + STREAM_AHEAD
                rings[0].put(zp, load(zp))
            for lvl in range(s_, 0, -1):
                if not 2 * lvl * h[0] + lvl - 1 <= j < planes0 + lvl - 1:
                    continue
                zl = z_first + j - lvl * (h[0] + 1) + 1
                rem = s_ - lvl
                cur = (tile[1] + 2 * rem * h[1], tile[2] + 2 * rem * h[2])
                if lvl < s_ and not 0 <= zl < grid_shape[0]:
                    if mode in ("zero", "constant"):
                        rings[lvl].put(zl, torch.full(cur, fill,
                                                      dtype=src.dtype))
                        continue
                    if mode == "reflect":
                        continue
                x = torch.stack([read(lvl - 1, zl + dz)
                                 for dz in range(-h[0], h[0] + 1)])
                acc = tref._window_apply(x, spec.taps, h, (1,) + cur,
                                         src.dtype, terms)[0]
                if lvl < s_:
                    if not xy_in:
                        acc = restore_rim(acc, mode, value,
                                          [g0[1] - rem * h[1],
                                           g0[2] - rem * h[2]],
                                          grid_shape[1:], cur)
                    rings[lvl].put(zl, acc)
                    continue
                lz = zl - origin[0]
                ny = min(tile[1], out_shape[1] - base[1])
                nx = min(tile[2], out_shape[2] - base[2])
                out[lz, base[1]:base[1] + ny, base[2]:base[2] + nx] = \
                    acc[:ny, :nx]
    return out, n_int, n_rim


def stream_offset_table(spec, slot_of, row):
    """The streamed kernel's ``TabledOp`` offsets for one level and step,
    as ``build_tables`` in ``csrc/stencil.cu`` lays them out: tap ``k`` at
    ``slot_of(dz) + dy * row + dx``; a factor offset likewise on the
    innermost factor of its term (the lowest axis, dim 0 where the term
    has it), and its in-plane part alone on an outer factor, whose offset
    ``apply_point`` adds to the inner one's.  ``slot_of(dz)`` is the ring
    offset of the plane at dim-0 offset ``dz``.  Returns ``(taps,
    factor_offsets)``, each a list of ints in the kernel's order."""
    taps = [slot_of(o[0]) + o[1] * row + o[2] for o, _ in spec.taps]
    terms = (None if spec.structure == "dense"
             else _classify(3, spec.taps).compute_terms) or ()
    foffs = []
    for term in terms:
        for i, f in enumerate(term.factors):
            for o in f.offsets:
                off3 = [0, 0, 0]
                off3[f.axis] = o
                inner = off3[1] * row + off3[2]
                foffs.append(slot_of(off3[0]) + inner if i == 0 else inner)
    return taps, foffs


def tabled_apply(spec, flat, at, table):
    """``apply_point`` of ``csrc/stencil.cu`` at the positions ``at`` (a
    tensor of indices into ``flat``) through ``table``
    (:func:`stream_offset_table`): a tap chain summed from zero in tap
    order, or each factored term as nested sums over its factors
    (innermost first), the terms summed from zero."""
    taps, foffs = table
    terms = (None if spec.structure == "dense"
             else _classify(spec.ndim, spec.taps).compute_terms)
    zero = torch.zeros(at.shape, dtype=flat.dtype)
    if not terms:
        acc = zero
        for (_, c), off in zip(spec.taps, taps):
            acc = acc + c * flat[at + off]
        return acc
    values, first = [], 0
    for term in terms:
        spans = []
        for f in term.factors:
            spans.append(list(zip(f.coeffs, foffs[first:first + len(f.offsets)])))
            first += len(f.offsets)

        def nest(level, base):
            v = zero
            for c, off in spans[level]:
                inner = (flat[base + off] if level == 0
                         else nest(level - 1, base + off))
                v = v + c * inner
            return v
        values.append(nest(len(spans) - 1, at))
    if len(values) == 1:
        return values[0]
    total = zero
    for v in values:
        total = total + v
    return total


# ---------------------------------------------------------------------------
# The window kernel's CTAs in its shared memory (ranks 1-3, both entries)
# ---------------------------------------------------------------------------
def _stage_tables(args, k, b):
    """Stage ``k``'s linear tap and factor offsets in buffer ``b`` of the
    packed argument block, in the order ``apply_point`` reads them."""
    st = args.stage[k]
    taps = [args.tap_lin[b][i] for i in range(st.tap_first,
                                              st.tap_first + st.n_taps)]
    foffs = []
    for t in range(st.term_first, st.term_first + st.n_terms):
        for f in range(args.term_fac[t], args.term_fac[t] + args.term_nf[t]):
            first = args.fac_first[f]
            foffs += [args.foff_lin[b][j]
                      for j in range(first, first + args.fac_n[f])]
    return taps, foffs


def window_kernel_block(spec, src, tile, sweeps, *, itemsize=None,
                        origin=None, grid_shape=None, out_shape=None):
    """One fused block of ``sweeps`` applications of ``spec`` (a spec or
    a fusable pipeline) on a batch ``src`` of shape ``(B, *S)``, CTA by
    CTA as the window kernel runs it: ``src`` is the unpadded grids
    (pad-free, K1/K3), or with ``origin`` and ``grid_shape`` windows
    pre-padded by ``sweeps*H`` whose interiors ``out_shape`` sit at
    ``origin`` of the global grid (padded, K2/K4).

    The pack factor, the argument block (linear tap offsets) and the
    layout come from the port (:func:`repro_torch.core.plan.pack_factor`,
    ``kernels.engine._args``, :func:`repro_torch.core.plan.kernel_layout`)
    at ``itemsize`` (default ``src``'s: the layout depends on it, the
    values do not).  A CTA stacks the windows of its ``np`` grids along
    dim 0 of one flat shared array (buffer 1 after buffer 0), evaluates
    every point of each application's box by the linear offsets of
    ``apply_point`` in tap or factored order, asserts that every read
    stays in the buffer it reads and, for a packed CTA, in its own grid's
    plane, and restores a rim tile's ghosts in the next stage's mode
    (:func:`restore_rim` on the box, by global coordinate).  Returns
    ``(out, stats)``: ``stats`` counts the CTAs, the packed ones, the
    windows copied (a pad-free interior tile's, a padded tile's inside its
    input) and tested (the rest), and the points the applications
    formed; ``pack`` is the pack factor."""
    from repro_torch.core import plan as tplan
    from repro_torch.kernels import engine as teng
    padded = origin is not None
    stages = as_stages(spec)
    nd = spec.ndim
    batch = src.shape[0]
    src_shape = tuple(src.shape[1:])
    out_shape = tuple(out_shape or src_shape)
    grid_shape = tuple(grid_shape or src_shape)
    origin = tuple(origin or (0,) * nd)
    itemsize = itemsize or src.element_size()
    deep = tuple(sweeps * h for h in spec.halo)
    pack = 1 if nd == 3 else tplan.pack_factor(
        spec, out_shape, tile, sweeps, itemsize, batch, padded=padded)
    args = teng._args(spec, padded, sweeps, batch, grid_shape, tuple(tile),
                      src_shape, out_shape, origin, itemsize, 0, pack)
    ly = tplan.kernel_layout(tile, spec, sweeps, itemsize, padded=padded,
                             pack=pack)
    tables = [[_stage_tables(args, k, b) for b in range(2)]
              for k in range(len(stages))]
    acc = torch.float64 if src.dtype == torch.float64 else torch.float32
    out = torch.empty((batch,) + out_shape, dtype=src.dtype)
    stats = {"ctas": 0, "packed": 0, "copied": 0, "tested": 0, "points": 0,
             "pack": pack}
    win = tuple(t + 2 * w for t, w in zip(tile, deep))

    def carried(n_p, ext):
        """A box of ``n_p`` grids of extents ``ext`` as rank 3: the grids
        along dim 0 for rank 1-2, none for rank 3 (one grid per CTA)."""
        if nd == 3:
            return tuple(ext)
        return (n_p,) + (1,) * (2 - nd) + tuple(ext)

    def at(b, c3, cur3):
        """Flat positions of the box ``cur3`` at window coordinate ``c3``
        of buffer ``b``."""
        org = (ly.elems[0] if b else 0) + ly.base[b]
        q = torch.meshgrid(*[torch.arange(n) for n in cur3], indexing="ij")
        return (org + (c3[0] + q[0]) * ly.plane[b]
                + (c3[1] + q[1]) * ly.row + c3[2] + q[2])

    for item in range(0, batch, pack):
        n_p = min(pack, batch - item)
        grids = src[item:item + n_p]
        for base in tile_origins(out_shape, tile):
            g_org = [o + b for o, b in zip(origin, base)] if padded \
                else list(base)
            interior = is_interior(g_org, tile, deep, grid_shape)
            stats["ctas"] += 1
            stats["packed"] += n_p > 1
            if padded:
                idx = [torch.arange(b, b + w) for b, w in zip(base, win)]
                x = grids[(slice(None),) + tuple(torch.meshgrid(
                    *[i.clamp(max=n - 1) for i, n in zip(idx, src_shape)],
                    indexing="ij"))]
                for d, (i, n) in enumerate(zip(idx, src_shape)):
                    shape = [1] * nd
                    shape[d] = win[d]
                    x = torch.where((i < n).reshape(shape), x, 0.0)
                inside = all(b + w <= n
                             for b, w, n in zip(base, win, src_shape))
            elif interior:
                x = grids[(slice(None),) + tuple(
                    slice(o - w, o + t + w)
                    for o, t, w in zip(base, tile, deep))]
                inside = True
            else:
                x = torch.stack([_gather_window(
                    gr, base, tile, deep, stages[0].boundary_mode,
                    stages[0].boundary_value) for gr in grids])
                inside = False
            stats["copied" if inside else "tested"] += 1
            flat = torch.zeros(ly.elems[0] + ly.elems[1], dtype=acc)
            flat[at(0, (0, 0, 0), carried(n_p, win))] = \
                x.to(acc).reshape(carried(n_p, win))
            full3 = (0,) * (3 - nd) + deep
            rem3 = list(full3)
            t3 = carried(n_p, tile)
            step, total = 0, sweeps * len(stages)
            for _ in range(sweeps):
                for k, st in enumerate(stages):
                    bi = step & 1
                    halo3 = (0,) * (3 - nd) + tuple(st.halo)
                    rem3 = [r - h for r, h in zip(rem3, halo3)]
                    cur3 = tuple(t + 2 * r for t, r in zip(t3, rem3))
                    c3 = tuple(f - r for f, r in zip(full3, rem3))
                    pos = at(bi, c3, cur3)
                    taps, foffs = tables[k][bi]
                    lo = ly.elems[0] if bi else 0
                    hi = lo + ly.elems[bi]
                    data = lo + ly.lead
                    for off in taps + foffs:
                        assert lo <= int((pos + off).min()) \
                            and int((pos + off).max()) < hi, off
                        if nd < 3:      # no tap reaches another grid
                            plane = torch.div(pos + off - data,
                                              ly.plane[bi],
                                              rounding_mode="floor")
                            assert torch.equal(plane, torch.arange(
                                cur3[0]).reshape(-1, 1, 1).expand(cur3))
                    v = tabled_apply(st, flat, pos, (taps, foffs))
                    stats["points"] += v.numel()
                    step += 1
                    # (grids, *spatial extents) of this application
                    vb = v.reshape((cur3[0] if nd < 3 else 1,)
                                   + cur3[3 - nd:])
                    if step == total:
                        keep = tuple(slice(0, min(t, n - o)) for o, t, n in
                                     zip(base, tile, out_shape))
                        region = tuple(slice(o, o + kk.stop)
                                       for o, kk in zip(base, keep))
                        out[(slice(item, item + n_p),) + region] = \
                            vb[(slice(None),) + keep].to(src.dtype)
                        continue
                    if not interior:
                        nxt = stages[(k + 1) % len(stages)]
                        vb = restore_rim(vb, nxt.boundary_mode,
                                         nxt.boundary_value,
                                         [o - r for o, r in
                                          zip(g_org, rem3[3 - nd:])],
                                         grid_shape, cur3[3 - nd:])
                    flat[at(bi ^ 1, c3, cur3)] = vb.reshape(cur3)
    return out, stats
