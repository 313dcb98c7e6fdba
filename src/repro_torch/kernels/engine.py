"""Fused temporal-blocking stencil kernels K1-K4 and their wrappers.

The port's counterpart of ``repro.kernels.engine``.  One hand-written
CUDA kernel template (``csrc/stencil.cu``) replaces the reference's four
Pallas kernels; it runs ``sweeps`` fused applications of a chain of 1-4
stages, one stage for a :class:`StencilSpec`:

* **K1** — :func:`stencil_sweep`, pad-free: each window is read from
  the unpadded grid, a plain copy for an interior tile (its window inside
  the grid) and through the boundary index map of each element's global
  coordinate for a rim tile (replaces ``_padfree_kernel``);
* **K2** — :func:`stencil_window_sweep`, padded window: windows are read
  from an input that already carries ``sweeps*halo`` ghosts, with an
  ``origin`` that places it in the global grid (replaces ``_kernel``);
* **K3** — :func:`pipeline_sweep`, K1 for a fusable
  :class:`StencilPipeline`: the window is widened by ``sweeps`` times the
  sum of the stage radii and built with stage 0's extension, and between
  stage applications ghosts are restored per the next stage's mode
  (replaces ``_padfree_pipeline_kernel``);
* **K4** — :func:`pipeline_window_sweep`, K2 for a fusable pipeline
  (replaces ``_pipeline_kernel``).

Each kernel has a **plain PyTorch version** beside it
(:func:`stencil_sweep_plain`, :func:`stencil_window_sweep_plain`,
:func:`pipeline_sweep_plain`, :func:`pipeline_window_sweep_plain`) that
runs the kernel's own algorithm — the same tiles, the same windows, the
torch ``masked_window_sweeps`` / ``masked_window_pipeline`` core — with
every tile gathered at once as a leading batch.  A wrapper takes the
plain version only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.  Each kernel counts its launches in :data:`LAUNCHES`.
The kernels take float32, float64 and bfloat16 (computed in f32 and
rounded once at the store, as the reference accumulates).  K1/K2 of a
rank-3 spec stream each tile plane by plane along dim 0
(:func:`repro_torch.core.plan.stream_layout`); a tile there is a chunk of
``tile[0]`` planes of an xy tile.  A launch puts every tile of every
batch element on one grid axis (:func:`repro_torch.core.plan.launch_blocks`);
the default tile is fitted to a grid smaller than it, and a batch of such
grids of rank 1-2 packs several into one CTA
(:func:`repro_torch.core.plan.pack_factor`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import tracing
from ..core import plan as _plan
from ..core import ref as _ref
from ..core.stencil import StencilPipeline, StencilSpec, _classify, as_stages
from . import _build

#: Launches per kernel since the last :func:`reset_launches` — counted
#: where the kernel is launched and nowhere else (K5, sliding-window
#: attention, counts from ``kernels/swa.py``).
LAUNCHES: dict[str, int] = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}

#: The launches of :data:`LAUNCHES` on rank-3 grids (K1-K4 on the
#: streamed kernel), counted at the same place: a run's split by rank
#: is read from the run itself.
RANK3_LAUNCHES: dict[str, int] = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

#: The CUDA source that holds K1-K4.
SOURCE = "stencil.cu"

#: Launch records kept while :func:`count_tiles` is on: per K1-K4 launch,
#: the kernel, its load path and pack factor, device counters of its
#: tiles, load kinds and packed CTAs, and the shared memory it asked for
#: beside the plan's.
_TILE_RECORDS: list | None = None

# Argument pools (taps and factored terms are pooled across the stages).
_MAX_STAGES, _MAX_TAPS, _MAX_TERMS, _MAX_FACS, _MAX_FOFF = 4, 96, 16, 24, 96
_MODES = {"zero": 0, "constant": 1, "periodic": 2, "reflect": 3}
_ENTRY = {torch.float32: "casper_stencil_f32",
          torch.float64: "casper_stencil_f64",
          torch.bfloat16: "casper_stencil_bf16"}


def reset_launches() -> None:
    for counts in (LAUNCHES, RANK3_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation for narrow inputs; native otherwise (f64 exact)."""
    if torch.empty((), dtype=dtype).element_size() < 4:
        return torch.float32
    return dtype


# ---------------------------------------------------------------------------
# The C interface (mirrors struct CasperArgs in csrc/stencil.cu)
# ---------------------------------------------------------------------------
_I3 = ctypes.c_int * 3


class CasperStage(ctypes.Structure):
    _fields_ = [
        ("halo", _I3), ("mode", ctypes.c_int),
        ("tap_first", ctypes.c_int), ("n_taps", ctypes.c_int),
        ("term_first", ctypes.c_int), ("n_terms", ctypes.c_int),
        ("star", ctypes.c_int), ("value", ctypes.c_double),
    ]


class CasperArgs(ctypes.Structure):
    _fields_ = [
        ("padded", ctypes.c_int), ("rank", ctypes.c_int),
        ("sweeps", ctypes.c_int), ("batch", ctypes.c_int),
        ("n_stages", ctypes.c_int), ("async_load", ctypes.c_int),
        ("stream", ctypes.c_int), ("pack", ctypes.c_int),
        ("n_foff", ctypes.c_int),
        ("grid", _I3), ("tile", _I3), ("halo", _I3), ("src", _I3),
        ("out", _I3), ("origin", _I3),
        ("tiles", ctypes.c_void_p),
        ("stage", CasperStage * _MAX_STAGES),
        ("tap_lin", (ctypes.c_int * _MAX_TAPS) * 2),
        ("term_fac", ctypes.c_int * _MAX_TERMS),
        ("term_nf", ctypes.c_int * _MAX_TERMS),
        ("fac_first", ctypes.c_int * _MAX_FACS),
        ("fac_n", ctypes.c_int * _MAX_FACS),
        ("foff_lin", (ctypes.c_int * _MAX_FOFF) * 2),
        ("tap_dz", ctypes.c_int * _MAX_TAPS),
        ("foff_dz", ctypes.c_int * _MAX_FOFF),
        ("tap_c", ctypes.c_double * _MAX_TAPS),
        ("fc", ctypes.c_double * _MAX_FOFF),
    ]


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_casper_bound", False):
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.casper_args_size.argtypes = []
        lib.casper_args_size.restype = ctypes.c_int
        lib.casper_smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.casper_smem_bytes.restype = ctypes.c_longlong
        lib.casper_error_string.argtypes = [ctypes.c_int]
        lib.casper_error_string.restype = ctypes.c_char_p
        lib.casper_copy_box.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_longlong] * 7 + [ctypes.c_int, ctypes.c_void_p])
        lib.casper_copy_box.restype = ctypes.c_int
        if lib.casper_args_size() != ctypes.sizeof(CasperArgs):
            raise RuntimeError(
                f"CasperArgs layout mismatch: C {lib.casper_args_size()} "
                f"bytes, Python {ctypes.sizeof(CasperArgs)}")
        lib._casper_bound = True
    return lib


def _rank3(v: Sequence[int], pad: int, fill: int) -> tuple[int, ...]:
    return (fill,) * pad + tuple(int(x) for x in v)


def _pack_stages(a: CasperArgs, spec, layout=None) -> None:
    """Fill the stage table and the pooled tap/term tables of ``a`` for
    ``spec`` (a spec: one stage; a pipeline: its stages), with tap and
    factor offsets made linear on ``layout``'s two buffers
    (:func:`repro_torch.core.plan.kernel_layout`, or the in-plane offsets
    of :func:`repro_torch.core.plan.stream_layout` with each offset's
    dim-0 part apart in ``tap_dz``/``foff_dz``; ``None`` leaves them 0).
    Raises ``ValueError`` when the chain exceeds the pools."""
    stages = as_stages(spec)
    if len(stages) > _MAX_STAGES:
        raise ValueError(f"{spec.name}: {len(stages)} stages exceed the CUDA "
                         f"kernels' {_MAX_STAGES}")
    nd = spec.ndim
    pad = 3 - nd
    a.n_stages = len(stages)
    ntap = nterm = nfac = noff = 0
    for k, st in enumerate(stages):
        s = a.stage[k]
        s.halo[:] = _rank3(st.halo, pad, 0)
        s.mode, s.value = _MODES[st.boundary_mode], st.boundary_value
        if ntap + st.n_taps > _MAX_TAPS:
            raise ValueError(f"{spec.name}: more than {_MAX_TAPS} taps over "
                             "all stages")
        s.tap_first, s.n_taps = ntap, st.n_taps
        for off, c in st.taps:
            off3 = _rank3(off, pad, 0)
            if layout is not None:
                for b in range(2):
                    a.tap_lin[b][ntap] = layout.offset(b, off3)
            a.tap_dz[ntap] = off3[0]
            a.tap_c[ntap] = c
            ntap += 1
        terms = (None if st.structure == "dense"
                 else _classify(nd, st.taps).compute_terms) or ()
        s.term_first, s.n_terms = nterm, len(terms)
        s.star = (nd if not terms and _is_unit_star(st)
                  else _CORE27 if _is_core27(nd, terms) else 0)
        for term in terms:
            if nterm >= _MAX_TERMS or nfac + len(term.factors) > _MAX_FACS:
                raise ValueError(f"{spec.name}: too many factored terms")
            a.term_fac[nterm], a.term_nf[nterm] = nfac, len(term.factors)
            nterm += 1
            for f in term.factors:
                if noff + len(f.offsets) > _MAX_FOFF:
                    raise ValueError(f"{spec.name}: too many factor offsets")
                a.fac_first[nfac], a.fac_n[nfac] = noff, len(f.offsets)
                for o, c in zip(f.offsets, f.coeffs):
                    off3 = [0, 0, 0]
                    off3[f.axis + pad] = o
                    if layout is not None:
                        for b in range(2):
                            a.foff_lin[b][noff] = layout.offset(b, off3)
                    a.foff_dz[noff] = off3[0]
                    a.fc[noff] = c
                    noff += 1
                nfac += 1
    a.n_foff = noff


#: ``CasperStage.star`` of a stage the streamed kernel runs as star33_3d's
#: structure with its coefficients in registers (``Core27``).
_CORE27 = 27


def _is_core27(nd: int, terms) -> bool:
    """Whether factored ``terms`` are star33_3d's: one separable term of
    three factors of offsets (-1, 0, 1) along dims 0, 1, 2, then one term
    of offsets (-2, 2) along each of dims 0, 1 and 2, in that order."""
    if nd != 3 or not terms or len(terms) != 4:
        return False
    core = terms[0].factors
    if [(f.axis, tuple(f.offsets)) for f in core] != [
            (d, (-1, 0, 1)) for d in range(3)]:
        return False
    return all(len(t.factors) == 1 and t.factors[0].axis == d
               and tuple(t.factors[0].offsets) == (-2, 2)
               for d, t in enumerate(terms[1:]))


def _is_unit_star(st: StencilSpec) -> bool:
    """Whether ``st``'s taps are the radius-1 star of rank 2 or 3 in the
    paper stencils' order (center, then -1 and +1 along each axis in
    turn): the kernel runs those in strips along the rows."""
    if st.ndim not in (2, 3):
        return False
    want = [(0,) * st.ndim]
    for d in range(st.ndim):
        for sgn in (-1, 1):
            off = [0] * st.ndim
            off[d] = sgn
            want.append(tuple(off))
    return [tuple(off) for off, _ in st.taps] == want


@functools.lru_cache(maxsize=256)
def check_kernel_args(spec) -> None:
    """Raise ``ValueError`` unless ``spec``'s stage chain fits the CUDA
    kernels' argument pools — asked at lowering, on every device."""
    _pack_stages(CasperArgs(), spec)


#: ``CasperArgs.async_load`` per load path
#: (:func:`repro_torch.core.plan.load_path`).
_ASYNC_LOAD = {"plain": 0, "async": 1, "elem": 2}

#: The load kinds a CTA counts on the card, in counter order after the
#: interior and rim tiles: its window copied by 16-byte ``cp.async``, by a
#: 4- or 8-byte ``cp.async`` per element, element by element through
#: registers, or element by element with a boundary test (masked past a
#: padded input's end, mapped through a pad-free grid's index map).
LOAD_KINDS = ("async16", "elem", "plain", "tested")


@functools.lru_cache(maxsize=1024)
def _args(spec, padded: bool, sweeps: int, batch: int,
          grid_shape: tuple, tile: tuple, src: tuple, out: tuple,
          origin: tuple, itemsize: int, async_load: int,
          pack: int = 1) -> CasperArgs:
    """Pack one launch's arguments; every rank is carried as rank 3."""
    if max(grid_shape + src + out) >= 2 ** 31:
        raise ValueError("the CUDA kernels take extents below 2**31 per dim")
    pad = 3 - spec.ndim
    a = CasperArgs()
    a.padded, a.rank, a.sweeps, a.batch = int(padded), spec.ndim, sweeps, batch
    a.async_load = int(async_load)
    a.stream = int(_plan.streams(spec))
    a.pack = pack
    a.grid[:] = _rank3(grid_shape, pad, 1)
    a.tile[:] = _rank3(tile, pad, 1)
    a.halo[:] = _rank3(spec.halo, pad, 0)
    a.src[:] = _rank3(src, pad, 1)
    a.out[:] = _rank3(out, pad, 1)
    a.origin[:] = _rank3(origin, pad, 0)
    layout = (_plan.stream_layout(tile, spec, sweeps, itemsize) if a.stream
              else _plan.kernel_layout(tile, spec, sweeps, itemsize,
                                       padded=padded, pack=pack))
    _pack_stages(a, spec, layout)
    return a


def _launch(kernel: str, spec, src: torch.Tensor, out: torch.Tensor, *,
            sweeps: int, tile: tuple, grid_shape: tuple, out_shape: tuple,
            origin: tuple) -> None:
    """Launch ``kernel`` (K1-K4: padded for K2/K4) on the current
    stream.  The windows that need no boundary test load on the path
    :func:`repro_torch.core.plan.load_path` fixes from the input's shape,
    the tile, dtype and alignment (the streamed rank-3 kernel's padded
    planes keep their own element copies), and a batch of small grids of
    rank 1-2 packs :func:`repro_torch.core.plan.pack_factor` grids into
    each CTA."""
    with tracing.span("casper.launch"):
        padded = kernel in ("K2", "K4")
        streamed = _plan.streams(spec)
        itemsize = src.element_size()
        batch = src.shape[0]
        src_shape = tuple(src.shape[1:])
        pack = 1 if streamed else _plan.pack_factor(
            spec, out_shape, tile, sweeps, itemsize, batch, padded=padded)
        _plan.launch_blocks(out_shape, tile, batch, pack)
        lib = _lib()
        path = ("plain" if padded and streamed
                else _plan.load_path(src_shape, tile, itemsize, src.data_ptr(),
                                     padded=padded))
        a = _args(spec, padded, sweeps, batch, grid_shape, tile, src_shape,
                  out_shape, origin, itemsize, _ASYNC_LOAD[path], pack)
        counter = None
        if _TILE_RECORDS is not None:
            a = CasperArgs.from_buffer_copy(a)
            counter = torch.zeros(3 + len(LOAD_KINDS), dtype=torch.int32,
                                  device=src.device)
            a.tiles = counter.data_ptr()
        fn = getattr(lib, _ENTRY[src.dtype])
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.device.index, src.data_ptr(), out.data_ptr(),
                 ctypes.addressof(a), stream)
        if err:
            raise RuntimeError(f"{kernel} launch failed: "
                               f"{lib.casper_error_string(err).decode()}")
        LAUNCHES[kernel] += 1
        if src.dim() == 4:
            RANK3_LAUNCHES[kernel] += 1
        if counter is not None:
            _TILE_RECORDS.append({
                "kernel": kernel, "path": path, "stream": streamed,
                "pack": pack, "tiles": counter,
                "smem_launch": lib.casper_smem_bytes(ctypes.addressof(a),
                                                     itemsize),
                "smem_plan": _plan.smem_bytes(tile, spec, sweeps, itemsize,
                                              padded=padded, pack=pack)})


def count_tiles(on: bool = True) -> None:
    """Start (clearing what was kept) or stop keeping a record of every
    K1-K4 launch: its kernel, load path, pack factor, whether it
    streamed (rank 3), device counters of the interior and rim tiles it
    ran, of its CTAs by load kind (:data:`LOAD_KINDS`; the streamed
    kernel counts none) and of its CTAs that carried more than one grid
    (read by :func:`tile_records`), and its shared memory beside
    :func:`repro_torch.core.plan.smem_bytes`."""
    global _TILE_RECORDS
    _TILE_RECORDS = [] if on else None


def tile_records() -> list[dict]:
    """The launches recorded since :func:`count_tiles`, with their
    counters read back: ``interior``, ``rim``, ``loads`` (CTAs per load
    kind) and ``packed`` (CTAs of more than one grid)."""
    out = []
    for r in _TILE_RECORDS or ():
        counts = r["tiles"].tolist()
        out.append({k: v for k, v in r.items() if k != "tiles"}
                   | {"interior": counts[0], "rim": counts[1],
                      "loads": dict(zip(LOAD_KINDS, counts[2:-1])),
                      "packed": counts[-1]})
    return out


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _ENTRY:
        raise TypeError(f"{what}: the CUDA kernels take float32/float64/"
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernels need a contiguous "
                         "tensor")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _batched(spec, x: torch.Tensor, what: str):
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


def _padfree_windows(g: torch.Tensor, tile, wide, mode: str, value: float):
    """Every tile's ``tile + 2*wide`` window of the unpadded ``(B, *S)``
    grid, each element gathered through the boundary index map of its
    global coordinate under ``mode`` (what K1/K3 load)."""
    n_shape = tuple(g.shape[1:])
    nd = len(tile)
    nt = _n_tiles(n_shape, tile)
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
    return windows, nt


def _padded_windows(w: torch.Tensor, out_shape, tile, wide):
    """Every tile's ``tile + 2*wide`` block of the padded ``(B, *W)``
    window, zero-extended at its end to whole tiles (what K2/K4 load)."""
    nd = len(tile)
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
    return _gather_windows(xp, idx), nt


def _fused_core(spec, windows, tile, sweeps, starts, grid_shape, acc):
    """The fused core of the plain versions: ``masked_window_sweeps``
    for a spec, ``masked_window_pipeline`` for a pipeline."""
    if isinstance(spec, StencilPipeline):
        return _ref.masked_window_pipeline(windows, spec.stages, tile, sweeps,
                                           starts, grid_shape, acc)
    return _ref.masked_window_sweeps(
        windows, spec.taps, spec.halo, tile, sweeps, starts, grid_shape, acc,
        mode=spec.boundary_mode, value=spec.boundary_value,
        structure=spec.structure)


def stencil_sweep_plain(spec, grid: torch.Tensor, tile: Sequence[int],
                        sweeps: int = 1) -> torch.Tensor:
    """Plain version of K1 (of K3 for a pipeline): each tile's window
    ``tile + 2*sweeps*halo`` gathered from the unpadded grid through the
    boundary index map of its global coordinate (stage 0's for a
    pipeline), then the torch ``masked_window_sweeps`` (or
    ``masked_window_pipeline``)."""
    g, batched = _batched(spec, grid, "grid")
    tile = tuple(tile)
    n_shape = tuple(g.shape[1:])
    wide = tuple(sweeps * h for h in spec.halo)
    windows, nt = _padfree_windows(g, tile, wide, spec.boundary_mode,
                                   spec.boundary_value)
    starts = _tile_starts(nt, tile, g.shape[0], (0,) * spec.ndim, g.device)
    y = _fused_core(spec, windows, tile, sweeps, starts, n_shape,
                    _acc_dtype(g.dtype))
    out = _untile(y, g.shape[0], nt, tile, n_shape, g.dtype)
    return out if batched else out[0]


def stencil_window_sweep_plain(spec, window: torch.Tensor,
                               out_shape: Sequence[int], origin,
                               grid_shape: Sequence[int],
                               tile: Sequence[int], sweeps: int = 1
                               ) -> torch.Tensor:
    """Plain version of K2 (of K4 for a pipeline): the window
    zero-extended at its end to whole tiles, each tile's
    ``tile + 2*sweeps*halo`` block sliced at the tile's local offset,
    then the fused core with global coordinates shifted by ``origin``."""
    w, batched = _batched(spec, window, "window")
    tile, out_shape = tuple(tile), tuple(int(n) for n in out_shape)
    wide = tuple(sweeps * h for h in spec.halo)
    windows, nt = _padded_windows(w, out_shape, tile, wide)
    starts = _tile_starts(nt, tile, w.shape[0], tuple(origin), w.device)
    y = _fused_core(spec, windows, tile, sweeps, starts,
                    tuple(int(n) for n in grid_shape), _acc_dtype(w.dtype))
    out = _untile(y, w.shape[0], nt, tile, out_shape, w.dtype)
    return out if batched else out[0]


def pipeline_sweep_plain(pipeline: StencilPipeline, grid: torch.Tensor,
                         tile: Sequence[int], sweeps: int = 1
                         ) -> torch.Tensor:
    """Plain version of K3: each tile's window ``tile + 2*sweeps*H``
    (``H`` the sum of the stage radii) gathered from the unpadded grid
    through stage 0's boundary index map, then the torch
    ``masked_window_pipeline``."""
    return stencil_sweep_plain(pipeline, grid, tile, sweeps)


def pipeline_window_sweep_plain(pipeline: StencilPipeline,
                                window: torch.Tensor,
                                out_shape: Sequence[int], origin,
                                grid_shape: Sequence[int],
                                tile: Sequence[int], sweeps: int = 1
                                ) -> torch.Tensor:
    """Plain version of K4: K2's tiling of a window pre-padded to depth
    ``sweeps*H`` with stage 0's mode, then the torch
    ``masked_window_pipeline``."""
    return stencil_window_sweep_plain(pipeline, window, out_shape, origin,
                                      grid_shape, tile, sweeps)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def _window_sweep(spec, window, out_shape, origin, grid_shape, tile,
                  sweeps, out=None) -> torch.Tensor:
    """K2 (spec) or K4 (pipeline) on a window that already carries its
    ``sweeps*halo`` ghosts; the plain version for a CPU tensor.  ``out``:
    a contiguous tensor of the result's shape, dtype and device to write
    into (the slab executor's output ring)."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    w, batched = _batched(spec, window, "window")
    itemsize = w.element_size()
    out_shape = tuple(int(n) for n in out_shape)
    tile = _plan.normalize_tile(spec, tile, sweeps, itemsize, out_shape)
    grid_shape = tuple(int(n) for n in grid_shape)
    origin = tuple(int(o) for o in origin)
    wide = tuple(sweeps * h for h in spec.halo)
    want = tuple(n + 2 * s for n, s in zip(out_shape, wide))
    if tuple(w.shape[1:]) != want:
        raise ValueError(f"window shape {tuple(w.shape[1:])} != out_shape "
                         f"+ 2*sweeps*halo {want}")
    full = (w.shape[0],) + out_shape
    if out is not None:
        if (tuple(out.shape) != (full if batched else out_shape)
                or out.dtype != w.dtype or out.device != w.device
                or not out.is_contiguous()):
            raise ValueError(f"out: a contiguous {w.dtype} tensor of shape "
                             f"{full if batched else out_shape} on "
                             f"{w.device} expected")
        given, out = out, out.view(full)
    if _device_kind(w) == "cpu":
        res = stencil_window_sweep_plain(spec, w, out_shape, origin,
                                         grid_shape, tile, sweeps)
        if out is not None:
            out.copy_(res)
            return given
        return res if batched else res[0]
    _check_cuda_input(w, "window")
    _plan._check_tile_fits(spec, tile, sweeps, itemsize)
    if out is None:
        given = None
        out = torch.empty(full, dtype=w.dtype, device=w.device)
    if out.numel():
        _launch("K4" if isinstance(spec, StencilPipeline) else "K2", spec,
                w, out, sweeps=sweeps, tile=tile,
                grid_shape=grid_shape, out_shape=out_shape, origin=origin)
    if given is not None:
        return given
    return out if batched else out[0]


def _sweep(spec, grid, tile, sweeps, strategy) -> torch.Tensor:
    """``sweeps`` fused applications of ``spec`` (a spec or a fusable
    pipeline): K1/K3 pad-free, or one ``pad_boundary`` copy with stage
    0's mode and K2/K4."""
    pipeline = isinstance(spec, StencilPipeline)
    g, batched = _batched(spec, grid, "grid")
    itemsize = g.element_size()
    n_shape = tuple(g.shape[1:])
    tile = _plan.normalize_tile(spec, tile, sweeps, itemsize, n_shape)
    if strategy is None:
        strategy = _plan.ghost_strategy_for(spec, n_shape, itemsize, sweeps,
                                            tile)
    if strategy == "padded-window":
        wide = tuple(sweeps * h for h in spec.halo)
        window = _ref.pad_boundary(g, wide, spec.boundary_mode,
                                   spec.boundary_value)
        out = _window_sweep(spec, window, n_shape, (0,) * spec.ndim,
                            n_shape, tile, sweeps)
    elif strategy != "pad-free":
        raise ValueError(f"unknown kernel ghost strategy {strategy!r}")
    elif _device_kind(g) == "cpu":
        out = stencil_sweep_plain(spec, g, tile, sweeps)
    else:
        _check_cuda_input(g, "grid")
        _plan._check_tile_fits(spec, tile, sweeps, itemsize)
        out = torch.empty_like(g)
        if out.numel():
            _launch("K3" if pipeline else "K1", spec, g, out, sweeps=sweeps,
                    tile=tile, grid_shape=n_shape, out_shape=n_shape,
                    origin=(0,) * spec.ndim)
    return out if batched else out[0]


def stencil_window_sweep(spec: StencilSpec, window: torch.Tensor,
                         out_shape: Sequence[int], origin,
                         grid_shape: Sequence[int],
                         tile: Sequence[int] | int | None = None,
                         sweeps: int = 1, out=None) -> torch.Tensor:
    """K2: ``sweeps`` fused applications to a window (optional leading
    batch dim) that already carries ``sweeps*halo`` ghosts per side; the
    interior's origin sits at global coordinate ``origin`` of a
    ``grid_shape`` grid.  ``out``: a contiguous tensor to write the
    result into."""
    return _window_sweep(spec, window, out_shape, origin, grid_shape, tile,
                         sweeps, out)


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
    return _sweep(spec, grid, tile, sweeps, strategy)


def stencil_apply(spec: StencilSpec, grid: torch.Tensor,
                  tile: Sequence[int] | int | None = None,
                  sweeps: int = 1,
                  strategy: str | None = None) -> torch.Tensor:
    """Rank-dispatching entry point: ``grid.ndim == spec.ndim`` is one
    grid, ``spec.ndim + 1`` a batch whose dim 0 becomes one more axis of
    the kernel's launch grid (one launch for the whole batch)."""
    return stencil_sweep(spec, grid, tile=tile, sweeps=sweeps,
                         strategy=strategy)


def _require_fusable(pipeline: StencilPipeline, what: str) -> None:
    if not pipeline.fusable:
        raise ValueError(
            f"{pipeline.name}: mixed periodic/non-periodic stages cannot run "
            f"fused ({what}); use strategy='staged' or lower the pipeline")


def pipeline_window_sweep(pipeline: StencilPipeline, window: torch.Tensor,
                          out_shape: Sequence[int], origin,
                          grid_shape: Sequence[int],
                          tile: Sequence[int] | int | None = None,
                          sweeps: int = 1, out=None) -> torch.Tensor:
    """K4: ``sweeps`` fused chain applications to a window that already
    carries ``sweeps*H`` ghosts (``H`` the sum of the stage radii) filled
    with stage 0's extension; the interior's origin sits at global
    coordinate ``origin`` of a ``grid_shape`` grid.  ``out``: a
    contiguous tensor to write the result into."""
    _require_fusable(pipeline, "padded window")
    return _window_sweep(pipeline, window, out_shape, origin, grid_shape,
                         tile, sweeps, out)


def pipeline_sweep(pipeline: StencilPipeline, grid: torch.Tensor,
                   tile: Sequence[int] | int | None = None,
                   sweeps: int = 1,
                   strategy: str | None = None) -> torch.Tensor:
    """``sweeps`` fused applications of a stage chain: each tile reads its
    ``sweeps*H``-widened window once and writes its tile once; every
    intermediate stage field stays in shared memory.

    ``"pad-free"`` runs K3 on the unpadded grid; ``"padded-window"``
    builds one ``pad_boundary`` copy with stage 0's mode at depth
    ``sweeps*H`` and runs K4 on it; ``"staged"`` (the default for a chain
    that is not fusable) runs each stage as one single-sweep K1/K2 call,
    ``sweeps`` times over.  ``None`` asks
    :func:`repro_torch.core.plan.ghost_strategy_for`.
    """
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if strategy is None and not pipeline.fusable:
        strategy = "staged"
    if strategy == "staged":
        out = grid
        for _ in range(sweeps):
            for stage in pipeline.stages:
                out = stencil_sweep(stage, out, tile=tile, sweeps=1)
        return out
    _require_fusable(pipeline, f"strategy {strategy!r}")
    return _sweep(pipeline, grid, tile, sweeps, strategy)


def pipeline_apply(pipeline: StencilPipeline, grid: torch.Tensor,
                   tile: Sequence[int] | int | None = None,
                   sweeps: int = 1,
                   strategy: str | None = None) -> torch.Tensor:
    """Pipeline form of :func:`stencil_apply`: one grid, or a leading
    batch dim as one more axis of the launch grid."""
    return pipeline_sweep(pipeline, grid, tile=tile, sweeps=sweeps,
                          strategy=strategy)


def run_sweeps(spec: StencilSpec, grid: torch.Tensor, iters: int,
               tile: Sequence[int] | int | str | None = None,
               sweeps: int = 1) -> torch.Tensor:
    """``iters`` applications of ``spec`` to ``grid`` (an optional leading
    batch dim), fused ``sweeps`` at a time on the grid's own device: one
    ``"cuda"`` plan through the plan cache, ``q`` fused blocks and one
    narrower remainder block (``plan.run_plan``)."""
    plan = _plan.lower(spec, _plan._grid_shape_for(spec, grid), grid.dtype,
                       backend="cuda", sweeps=sweeps, tile=tile,
                       device=grid.device)
    return _plan.run_plan(plan, grid, iters)


def execute_plan(plan, grid: torch.Tensor) -> torch.Tensor:
    """Executor of one lowered ``"cuda"`` plan: one fused block of
    ``plan.sweeps`` applications with the plan's tile and strategy
    (pipeline plans run K3/K4)."""
    if plan.backend != "cuda":
        raise ValueError(f"not a cuda plan: backend={plan.backend!r}")
    apply = pipeline_apply if plan.is_pipeline else stencil_apply
    return apply(plan.spec, grid, tile=plan.tile, sweeps=plan.sweeps,
                 strategy=plan.ghost_strategy)


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
    tile = _plan.normalize_tile(spec, tile, sweeps, itemsize, shape)
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


def hbm_pipeline_traffic(pipeline: StencilPipeline, shape: Sequence[int],
                         tile: Sequence[int] | None = None,
                         sweeps: int = 1,
                         itemsize: int = 4) -> dict[str, float]:
    """Bytes moved between device memory and the SMs for ``sweeps``
    fused chain applications vs the stage-by-stage chain —
    ``repro.kernels.engine.hbm_pipeline_traffic`` with the port's default
    tile.  ``fused``: one K3 call, each tile reading its ``sweeps*H``
    window once and writing its tile once; ``staged``: every one of the
    ``sweeps * n_stages`` stage passes as a pad-free single-sweep call
    with its own windows (a lower bound on the staged chain's bytes);
    ``intermediate_bytes``: the intermediate fields the fusion keeps out
    of device memory."""
    if tile is None:
        tile = _plan.default_tile(pipeline, sweeps, itemsize)
    tile = tuple(tile)
    n_tiles = math.prod(-(-n // t) for n, t in zip(shape, tile))
    out_b = math.prod(tile) * itemsize

    def window_bytes(layers: Sequence[int]) -> int:
        return math.prod(t + 2 * w for t, w in zip(tile, layers)) * itemsize

    fused = n_tiles * (window_bytes(tuple(sweeps * h
                                          for h in pipeline.halo)) + out_b)
    staged = sweeps * sum(
        n_tiles * (window_bytes(stage.halo) + out_b)
        for stage in pipeline.stages)
    grid_b = math.prod(shape) * itemsize
    passes = sweeps * pipeline.n_stages
    return {
        "fused_bytes": float(fused),
        "staged_bytes": float(staged),
        "reduction": staged / fused,
        "intermediate_bytes": float(2 * (passes - 1) * grid_b),
        "n_stage_passes": float(passes),
    }
