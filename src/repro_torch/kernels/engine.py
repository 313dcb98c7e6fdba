"""Fused temporal-blocking stencil kernels K1/K2 and their wrappers.

The port's counterpart of ``repro.kernels.engine``.  Two hand-written
CUDA kernels (``csrc/stencil.cu``) replace the reference's Pallas
kernels:

* **K1** — :func:`stencil_sweep`, pad-free: each window element is
  loaded from the unpadded grid through the boundary index map of its
  global coordinate (replaces ``_padfree_kernel``);
* **K2** — :func:`stencil_window_sweep`, padded window: windows are read
  from an input that already carries ``sweeps*halo`` ghosts, with an
  ``origin`` that places it in the global grid (replaces ``_kernel``).

Each kernel has a **plain PyTorch version** beside it
(:func:`stencil_sweep_plain`, :func:`stencil_window_sweep_plain`) that
runs the kernel's own algorithm — the same tiles, the same windows, the
torch ``masked_window_sweeps`` core — with every tile gathered at once
as a leading batch.  A wrapper takes the plain version only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.  Each kernel
counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core import plan as _plan
from ..core import ref as _ref
from ..core.stencil import StencilSpec, _classify
from . import _build

#: Launches per kernel since the last :func:`reset_launches` — counted
#: where the kernel is launched and nowhere else.
LAUNCHES: dict[str, int] = {"K1": 0, "K2": 0}

#: The CUDA source that holds K1 and K2.
SOURCE = "stencil.cu"

_MAX_TAPS, _MAX_TERMS, _MAX_FACS, _MAX_FOFF = 64, 8, 12, 64
_MODES = {"zero": 0, "constant": 1, "periodic": 2, "reflect": 3}
_KERNEL_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation for narrow inputs; native otherwise (f64 exact)."""
    if torch.empty((), dtype=dtype).element_size() < 4:
        return torch.float32
    return dtype


# ---------------------------------------------------------------------------
# The C interface (mirrors struct CasperArgs in csrc/stencil.cu)
# ---------------------------------------------------------------------------
_I3 = ctypes.c_int * 3


class CasperArgs(ctypes.Structure):
    _fields_ = [
        ("padded", ctypes.c_int), ("mode", ctypes.c_int),
        ("sweeps", ctypes.c_int), ("batch", ctypes.c_int),
        ("grid", _I3), ("tile", _I3), ("halo", _I3), ("src", _I3),
        ("out", _I3), ("origin", _I3),
        ("n_taps", ctypes.c_int), ("n_terms", ctypes.c_int),
        ("tap_off", _I3 * _MAX_TAPS),
        ("term_first", ctypes.c_int * _MAX_TERMS),
        ("term_nf", ctypes.c_int * _MAX_TERMS),
        ("fac_axis", ctypes.c_int * _MAX_FACS),
        ("fac_first", ctypes.c_int * _MAX_FACS),
        ("fac_n", ctypes.c_int * _MAX_FACS),
        ("foff", ctypes.c_int * _MAX_FOFF),
        ("value", ctypes.c_double),
        ("tap_c", ctypes.c_double * _MAX_TAPS),
        ("fc", ctypes.c_double * _MAX_FOFF),
    ]


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_casper_bound", False):
        for name in ("casper_stencil_f32", "casper_stencil_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.casper_args_size.argtypes = []
        lib.casper_args_size.restype = ctypes.c_int
        lib.casper_error_string.argtypes = [ctypes.c_int]
        lib.casper_error_string.restype = ctypes.c_char_p
        if lib.casper_args_size() != ctypes.sizeof(CasperArgs):
            raise RuntimeError(
                f"CasperArgs layout mismatch: C {lib.casper_args_size()} "
                f"bytes, Python {ctypes.sizeof(CasperArgs)}")
        lib._casper_bound = True
    return lib


def _rank3(v: Sequence[int], pad: int, fill: int) -> tuple[int, ...]:
    return (fill,) * pad + tuple(int(x) for x in v)


@functools.lru_cache(maxsize=1024)
def _args(spec: StencilSpec, padded: bool, sweeps: int, batch: int,
          grid_shape: tuple, tile: tuple, src: tuple, out: tuple,
          origin: tuple) -> CasperArgs:
    """Pack one launch's arguments; every rank is carried as rank 3."""
    if max(grid_shape + src + out) >= 2 ** 31:
        raise ValueError("the CUDA kernels take extents below 2**31 per dim")
    nd = spec.ndim
    pad = 3 - nd
    a = CasperArgs()
    a.padded, a.mode = int(padded), _MODES[spec.boundary_mode]
    a.sweeps, a.batch = sweeps, batch
    a.grid[:] = _rank3(grid_shape, pad, 1)
    a.tile[:] = _rank3(tile, pad, 1)
    a.halo[:] = _rank3(spec.halo, pad, 0)
    a.src[:] = _rank3(src, pad, 1)
    a.out[:] = _rank3(out, pad, 1)
    a.origin[:] = _rank3(origin, pad, 0)
    a.value = spec.boundary_value
    if spec.n_taps > _MAX_TAPS:
        raise ValueError(f"{spec.name}: {spec.n_taps} taps > {_MAX_TAPS}")
    a.n_taps = spec.n_taps
    for k, (off, c) in enumerate(spec.taps):
        a.tap_off[k][:] = _rank3(off, pad, 0)
        a.tap_c[k] = c
    terms = (None if spec.structure == "dense"
             else _classify(nd, spec.taps).compute_terms)
    a.n_terms = 0 if terms is None else len(terms)
    nfac = noff = 0
    for t, term in enumerate(terms or ()):
        if t >= _MAX_TERMS or nfac + len(term.factors) > _MAX_FACS:
            raise ValueError(f"{spec.name}: too many factored terms")
        a.term_first[t], a.term_nf[t] = nfac, len(term.factors)
        for f in term.factors:
            if noff + len(f.offsets) > _MAX_FOFF:
                raise ValueError(f"{spec.name}: too many factor offsets")
            a.fac_axis[nfac] = f.axis + pad
            a.fac_first[nfac], a.fac_n[nfac] = noff, len(f.offsets)
            for o, c in zip(f.offsets, f.coeffs):
                a.foff[noff], a.fc[noff] = o, c
                noff += 1
            nfac += 1
    return a


def _launch(kernel: str, spec: StencilSpec, src: torch.Tensor,
            out: torch.Tensor, *, sweeps: int, tile: tuple,
            grid_shape: tuple, out_shape: tuple, origin: tuple) -> None:
    """Launch K1 (``kernel="K1"``) or K2 on the current stream."""
    lib = _lib()
    a = _args(spec, kernel == "K2", sweeps, src.shape[0], grid_shape, tile,
              tuple(src.shape[1:]), out_shape, origin)
    fn = (lib.casper_stencil_f64 if src.dtype == torch.float64
          else lib.casper_stencil_f32)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = fn(src.device.index, src.data_ptr(), out.data_ptr(),
             ctypes.addressof(a), stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.casper_error_string(err).decode()}")
    LAUNCHES[kernel] += 1


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: the CUDA kernels take float32/float64, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernels need a contiguous "
                         "tensor")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _batched(spec: StencilSpec, x: torch.Tensor, what: str):
    if x.ndim == spec.ndim:
        return x.unsqueeze(0), False
    if x.ndim == spec.ndim + 1:
        return x, True
    raise ValueError(
        f"{what} rank {x.ndim} incompatible with spec ndim {spec.ndim} "
        f"(expected ndim or ndim+1 for a batched grid)")


# ---------------------------------------------------------------------------
# Plain versions: the kernels' algorithm, every tile at once
# ---------------------------------------------------------------------------
def _n_tiles(shape, tile) -> tuple[int, ...]:
    return tuple(-(-n // t) for n, t in zip(shape, tile))


def _tile_view(v: torch.Tensor, d: int, nd: int) -> torch.Tensor:
    """``(n_tiles_d, win_d)`` → broadcastable over ``(nt..., win...)``."""
    shape = [1] * (2 * nd)
    shape[d], shape[nd + d] = v.shape
    return v.reshape(shape)


def _gather_windows(x: torch.Tensor, idx) -> torch.Tensor:
    """``x`` ``(B, *S)`` and per-dim ``(n_tiles_d, win_d)`` indices →
    every tile's window, ``(B * prod(n_tiles), *win)``."""
    nd = len(idx)
    w = x[(slice(None),) + tuple(_tile_view(ix, d, nd)
                                 for d, ix in enumerate(idx))]
    return w.reshape((-1,) + tuple(ix.shape[1] for ix in idx))


def _tile_starts(nt, tile, batch, origin, device):
    """Global coordinate of each flattened tile's origin, per dim."""
    axes = torch.meshgrid(
        *[torch.arange(n, dtype=torch.int64, device=device) * t
          for n, t in zip(nt, tile)], indexing="ij")
    return tuple(a.reshape(1, -1).expand(batch, -1).reshape(-1) + int(o)
                 for a, o in zip(axes, origin))


def _untile(y: torch.Tensor, batch: int, nt, tile, out_shape,
            dtype) -> torch.Tensor:
    """``(B * prod(n_tiles), *tile)`` → ``(B, *out_shape)``."""
    nd = len(tile)
    y = y.reshape((batch,) + tuple(nt) + tuple(tile))
    perm = [0] + [p for d in range(nd) for p in (1 + d, 1 + nd + d)]
    y = y.permute(perm).reshape(
        (batch,) + tuple(n * t for n, t in zip(nt, tile)))
    return y[(slice(None),) + tuple(slice(0, n) for n in out_shape)] \
        .to(dtype).contiguous()


def stencil_sweep_plain(spec: StencilSpec, grid: torch.Tensor,
                        tile: Sequence[int], sweeps: int = 1
                        ) -> torch.Tensor:
    """Plain version of K1: each tile's window ``tile + 2*sweeps*halo``
    gathered from the unpadded grid through the boundary index map of its
    global coordinate, then the torch ``masked_window_sweeps``."""
    g, batched = _batched(spec, grid, "grid")
    tile = tuple(tile)
    n_shape = tuple(g.shape[1:])
    nd = spec.ndim
    wide = tuple(sweeps * h for h in spec.halo)
    nt = _n_tiles(n_shape, tile)
    mode, value = spec.boundary_mode, spec.boundary_value
    idx, valid = [], []
    for d in range(nd):
        gc = ((torch.arange(nt[d], dtype=torch.int64, device=g.device)
               * tile[d] - wide[d])[:, None]
              + torch.arange(tile[d] + 2 * wide[d], dtype=torch.int64,
                             device=g.device))
        if mode == "periodic":
            idx.append(_ref.periodic_index(gc, n_shape[d]))
        elif mode == "reflect":
            idx.append(_ref.reflect_index(gc, n_shape[d]))
        else:
            idx.append(gc.clamp(0, n_shape[d] - 1))
            valid.append(_tile_view((gc >= 0) & (gc < n_shape[d]), d, nd))
    windows = _gather_windows(g, idx)
    if valid:
        mask = functools.reduce(torch.logical_and, valid)
        win = windows.shape[1:]
        fill = value if mode == "constant" else 0.0
        windows = torch.where(mask.reshape((1, -1) + tuple(win)),
                              windows.reshape((g.shape[0], -1) + tuple(win)),
                              fill).reshape(windows.shape)
    starts = _tile_starts(nt, tile, g.shape[0], (0,) * nd, g.device)
    y = _ref.masked_window_sweeps(
        windows, spec.taps, spec.halo, tile, sweeps, starts, n_shape,
        _acc_dtype(g.dtype), mode=mode, value=value,
        structure=spec.structure)
    out = _untile(y, g.shape[0], nt, tile, n_shape, g.dtype)
    return out if batched else out[0]


def stencil_window_sweep_plain(spec: StencilSpec, window: torch.Tensor,
                               out_shape: Sequence[int], origin,
                               grid_shape: Sequence[int],
                               tile: Sequence[int], sweeps: int = 1
                               ) -> torch.Tensor:
    """Plain version of K2: the window zero-extended at its end to whole
    tiles, each tile's ``tile + 2*sweeps*halo`` block sliced at the
    tile's local offset, then the torch ``masked_window_sweeps`` with
    global coordinates shifted by ``origin``."""
    w, batched = _batched(spec, window, "window")
    tile, out_shape = tuple(tile), tuple(int(n) for n in out_shape)
    nd = spec.ndim
    wide = tuple(sweeps * h for h in spec.halo)
    nt = _n_tiles(out_shape, tile)
    pads = []
    for n, t in zip(reversed(out_shape), reversed(tile)):
        pads += [0, -n % t]
    xp = F.pad(w, pads)
    idx = [(torch.arange(nt[d], dtype=torch.int64, device=w.device)
            * tile[d])[:, None]
           + torch.arange(tile[d] + 2 * wide[d], dtype=torch.int64,
                          device=w.device)
           for d in range(nd)]
    windows = _gather_windows(xp, idx)
    starts = _tile_starts(nt, tile, w.shape[0], tuple(origin), w.device)
    y = _ref.masked_window_sweeps(
        windows, spec.taps, spec.halo, tile, sweeps, starts,
        tuple(int(n) for n in grid_shape), _acc_dtype(w.dtype),
        mode=spec.boundary_mode, value=spec.boundary_value,
        structure=spec.structure)
    out = _untile(y, w.shape[0], nt, tile, out_shape, w.dtype)
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def stencil_window_sweep(spec: StencilSpec, window: torch.Tensor,
                         out_shape: Sequence[int], origin,
                         grid_shape: Sequence[int],
                         tile: Sequence[int] | int | None = None,
                         sweeps: int = 1) -> torch.Tensor:
    """K2: ``sweeps`` fused applications to a window (optional leading
    batch dim) that already carries ``sweeps*halo`` ghosts per side; the
    interior's origin sits at global coordinate ``origin`` of a
    ``grid_shape`` grid."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    w, batched = _batched(spec, window, "window")
    itemsize = w.element_size()
    tile = _plan.normalize_tile(spec, tile, sweeps, itemsize)
    out_shape = tuple(int(n) for n in out_shape)
    grid_shape = tuple(int(n) for n in grid_shape)
    origin = tuple(int(o) for o in origin)
    wide = tuple(sweeps * h for h in spec.halo)
    want = tuple(n + 2 * s for n, s in zip(out_shape, wide))
    if tuple(w.shape[1:]) != want:
        raise ValueError(f"window shape {tuple(w.shape[1:])} != out_shape "
                         f"+ 2*sweeps*halo {want}")
    if _device_kind(w) == "cpu":
        out = stencil_window_sweep_plain(spec, w, out_shape, origin,
                                         grid_shape, tile, sweeps)
        return out if batched else out[0]
    _check_cuda_input(w, "window")
    _plan._check_tile_fits(spec, tile, sweeps, itemsize)
    out = torch.empty((w.shape[0],) + out_shape, dtype=w.dtype,
                      device=w.device)
    if out.numel():
        _launch("K2", spec, w, out, sweeps=sweeps, tile=tile,
                grid_shape=grid_shape, out_shape=out_shape, origin=origin)
    return out if batched else out[0]


def stencil_sweep(spec: StencilSpec, grid: torch.Tensor,
                  tile: Sequence[int] | int | None = None,
                  sweeps: int = 1,
                  strategy: str | None = None) -> torch.Tensor:
    """``sweeps`` fused applications of ``spec`` to ``grid`` (optional
    leading batch dim) under the spec's boundary mode.

    ``strategy="pad-free"`` runs K1 on the unpadded grid;
    ``"padded-window"`` builds one ``pad_boundary`` copy and runs K2 on
    it.  ``None`` asks :func:`repro_torch.core.plan.ghost_strategy_for`.
    """
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    g, batched = _batched(spec, grid, "grid")
    itemsize = g.element_size()
    tile = _plan.normalize_tile(spec, tile, sweeps, itemsize)
    n_shape = tuple(g.shape[1:])
    if strategy is None:
        strategy = _plan.ghost_strategy_for(spec, n_shape, itemsize, sweeps,
                                            tile)
    if strategy == "padded-window":
        wide = tuple(sweeps * h for h in spec.halo)
        window = _ref.pad_boundary(g, wide, spec.boundary_mode,
                                   spec.boundary_value)
        out = stencil_window_sweep(spec, window, n_shape, (0,) * spec.ndim,
                                   n_shape, tile=tile, sweeps=sweeps)
    elif strategy != "pad-free":
        raise ValueError(f"unknown kernel ghost strategy {strategy!r}")
    elif _device_kind(g) == "cpu":
        out = stencil_sweep_plain(spec, g, tile, sweeps)
    else:
        _check_cuda_input(g, "grid")
        _plan._check_tile_fits(spec, tile, sweeps, itemsize)
        out = torch.empty_like(g)
        if out.numel():
            _launch("K1", spec, g, out, sweeps=sweeps, tile=tile,
                    grid_shape=n_shape, out_shape=n_shape,
                    origin=(0,) * spec.ndim)
    return out if batched else out[0]


def stencil_apply(spec: StencilSpec, grid: torch.Tensor,
                  tile: Sequence[int] | int | None = None,
                  sweeps: int = 1,
                  strategy: str | None = None) -> torch.Tensor:
    """Rank-dispatching entry point: ``grid.ndim == spec.ndim`` is one
    grid, ``spec.ndim + 1`` a batch whose dim 0 becomes one more axis of
    the kernel's launch grid (one launch for the whole batch)."""
    return stencil_sweep(spec, grid, tile=tile, sweeps=sweeps,
                         strategy=strategy)


def execute_plan(plan, grid: torch.Tensor) -> torch.Tensor:
    """Executor of one lowered ``"cuda"`` plan: one fused block of
    ``plan.sweeps`` applications with the plan's tile and strategy."""
    if plan.backend != "cuda":
        raise ValueError(f"not a cuda plan: backend={plan.backend!r}")
    return stencil_apply(plan.spec, grid, tile=plan.tile,
                         sweeps=plan.sweeps, strategy=plan.ghost_strategy)


# ---------------------------------------------------------------------------
# Analytic HBM-traffic model for temporal blocking
# ---------------------------------------------------------------------------
def hbm_traffic(spec: StencilSpec, shape: Sequence[int],
                tile: Sequence[int] | None = None,
                sweeps: int = 1, itemsize: int = 4) -> dict[str, float]:
    """Bytes moved between device memory and the SMs for ``sweeps``
    applications — ``repro.kernels.engine.hbm_traffic`` with the port's
    default tile.  ``fused``: one pad-free call, each tile reading its
    ``tile + 2*sweeps*halo`` window once and writing its tile once;
    ``unfused``: ``sweeps`` single-sweep calls of the padded pipeline,
    each with its ``pad_boundary`` round trip."""
    if tile is None:
        tile = _plan.default_tile(spec, sweeps, itemsize)
    tile = tuple(tile)
    halo = spec.halo
    n_tiles = math.prod(-(-n // t) for n, t in zip(shape, tile))
    out_b = math.prod(tile) * itemsize
    grid_b = math.prod(shape) * itemsize

    def window_bytes(layers: int) -> int:
        return math.prod(t + 2 * layers * h
                         for t, h in zip(tile, halo)) * itemsize

    def pad_copy_bytes(layers: int) -> int:
        padded = math.prod(n + 2 * layers * h
                           for n, h in zip(shape, halo)) * itemsize
        return grid_b + padded          # read grid once, write padded copy

    fused = n_tiles * (window_bytes(sweeps) + out_b)
    unfused = sweeps * (n_tiles * (window_bytes(1) + out_b)
                        + pad_copy_bytes(1))
    return {
        "fused_bytes": float(fused),
        "unfused_bytes": float(unfused),
        "reduction": unfused / fused,
        "halo_overhead": n_tiles * window_bytes(sweeps) / fused,
        "pad_bytes_unfused": float(sweeps * pad_copy_bytes(1)),
        "legacy_fused_bytes": float(fused + pad_copy_bytes(sweeps)),
    }
