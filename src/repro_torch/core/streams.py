"""Stream abstraction (paper §3.2).

A framework-free copy of ``repro.core.streams`` for the PyTorch port.

A *stream* is a sequence of same-typed elements at consecutive addresses,
characterized by (start, width, count, cursor).  Because a stencil sweeps the
grid at a uniform pace, every tap can be served by a stream whose base points
at the tap's *row* (all offset dims except the innermost) plus a small
innermost-dim *shift* encoded in the instruction (paper §5.1, 1b direction +
3b amount, i.e. |shift| <= 7 elements).

Taps whose innermost offset exceeds the shift range get a dedicated stream —
same rule the paper's library would apply for very wide stencils (footnote 3:
complex stencils have 30-40 points; stream ids are 4 bits).

Streams are boundary-agnostic: a stream's base may point before the first or
past the last grid element, and whichever runtime executes the plan (the
software SPU VM here) serves those out-of-grid elements per the spec's
boundary mode table (zero / constant(c) / periodic / reflect — see
:mod:`repro_torch.core.stencil`).  The plan records the mode in ``boundary`` so
an assembled program is self-describing.
"""
from __future__ import annotations

import dataclasses

from .stencil import StencilSpec, factor_taps

MAX_SHIFT = 7          # 3-bit shift amount
MAX_STREAMS = 16       # 4-bit stream index (incl. the output stream 0)
MAX_CONSTS = 16        # 4-bit constant index
OUTPUT_STREAM = 0      # mirrors Fig. 8: initStream(&B[...], 0, ...)


@dataclasses.dataclass(frozen=True)
class Stream:
    """An input stream: base offset vector relative to the sweep cursor."""

    index: int
    base: tuple[int, ...]   # full-rank offset; innermost entry is the base x


@dataclasses.dataclass(frozen=True)
class PlannedTap:
    stream: int
    shift: int              # innermost-dim shift relative to the stream base
    coeff: float
    offset: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    spec_name: str
    ndim: int
    streams: tuple[Stream, ...]          # input streams (indices 1..N)
    taps: tuple[PlannedTap, ...]         # in execution order
    consts: tuple[float, ...]            # constant buffer contents
    boundary: str = "zero"               # how out-of-grid elements are served
    structure: str = "dense"             # tap-structure class (stencil.py)
    structured_ops: int = 0              # factored MACs/point (0 = n_taps)

    @property
    def n_input_streams(self) -> int:
        return len(self.streams)

    def const_index(self, coeff: float) -> int:
        return self.consts.index(coeff)


def plan_streams(spec: StencilSpec) -> StreamPlan:
    """Group taps into streams exactly as the paper's Jacobi-2D example does:

    one stream per distinct row (offset with innermost dim zeroed), shifts of
    up to +/-7 elements resolved by the unaligned-load mechanism.
    """
    # Row key -> stream. Rows sorted in memory order so the instruction
    # sequence walks streams in ascending address order (Fig. 9).
    rows: dict[tuple[int, ...], list[tuple[int, float, tuple[int, ...]]]] = {}
    extra: list[tuple[tuple[int, ...], float]] = []
    for off, coeff in spec.taps:
        row, dx = off[:-1], off[-1]
        if abs(dx) <= MAX_SHIFT:
            rows.setdefault(row, []).append((dx, coeff, off))
        else:
            extra.append((off, coeff))

    streams: list[Stream] = []
    taps: list[PlannedTap] = []
    idx = OUTPUT_STREAM + 1
    for row in sorted(rows):
        streams.append(Stream(index=idx, base=row + (0,)))
        for dx, coeff, off in sorted(rows[row]):
            taps.append(PlannedTap(stream=idx, shift=dx, coeff=coeff,
                                   offset=off))
        idx += 1
    for off, coeff in sorted(extra):
        streams.append(Stream(index=idx, base=off))
        taps.append(PlannedTap(stream=idx, shift=0, coeff=coeff, offset=off))
        idx += 1

    if idx > MAX_STREAMS:
        raise ValueError(
            f"stencil {spec.name} needs {idx - 1} input streams; the 4-bit "
            f"stream index caps at {MAX_STREAMS - 1}")

    consts: list[float] = []
    for _, coeff in spec.taps:
        if coeff not in consts:
            consts.append(coeff)
    if len(consts) > MAX_CONSTS:
        raise ValueError(
            f"stencil {spec.name} has {len(consts)} distinct coefficients; "
            f"the 4-bit constant index caps at {MAX_CONSTS}")

    fz = factor_taps(spec)
    return StreamPlan(
        spec_name=spec.name,
        ndim=spec.ndim,
        streams=tuple(streams),
        taps=tuple(taps),
        consts=tuple(consts),
        boundary=spec.boundary,
        structure=spec.structure,
        structured_ops=fz.tap_ops,
    )
