"""The 15-bit Casper ISA (paper §5.1, Fig. 7) and its assembler.

A framework-free copy of ``repro.core.isa`` for the PyTorch port; every
plan carries ``program=assemble(spec)``.

Instruction layout (msb..lsb):

    [const:4][stream:4][shdir:1][shamt:3][clear_acc:1][enable_out:1][advance:1]

* ``const``      indexes the constant buffer (the MAC multiplicand)
* ``stream``     indexes the stream buffer (which row to load from)
* ``shdir``      0 = shift left (+x, future elements), 1 = shift right (-x)
                 — Fig. 9: loading A[j][i-1] is "shift right by 1"
* ``shamt``      shift magnitude in elements (0..7)
* ``clear_acc``  first instruction of each grid point resets the accumulator
* ``enable_out`` last instruction stores the accumulator to the output stream
* ``advance``    advance this stream's cursor (set on the last instruction
                 consuming each stream)

The same instruction sequence executes for every grid point, which is why the
paper's instruction buffer holds at most 64 compressed instructions.
"""
from __future__ import annotations

import dataclasses

from .stencil import StencilPipeline, StencilSpec
from .streams import MAX_SHIFT, StreamPlan, plan_streams

INSTR_BITS = 15


@dataclasses.dataclass(frozen=True)
class Instr:
    const: int
    stream: int
    shdir: int
    shamt: int
    clear_acc: bool
    enable_out: bool
    advance: bool

    def __post_init__(self):
        if not (0 <= self.const < 16 and 0 <= self.stream < 16):
            raise ValueError("const/stream must fit 4 bits")
        if self.shdir not in (0, 1) or not (0 <= self.shamt <= MAX_SHIFT):
            raise ValueError("bad shift encoding")

    @property
    def shift(self) -> int:
        """Signed innermost-dim offset: right shift (shdir=1) loads -x."""
        return -self.shamt if self.shdir else self.shamt

    def encode(self) -> int:
        word = (
            (self.const << 11)
            | (self.stream << 7)
            | (self.shdir << 6)
            | (self.shamt << 3)
            | (int(self.clear_acc) << 2)
            | (int(self.enable_out) << 1)
            | int(self.advance)
        )
        assert word < (1 << INSTR_BITS)
        return word


def decode(word: int) -> Instr:
    if not (0 <= word < (1 << INSTR_BITS)):
        raise ValueError(f"word does not fit {INSTR_BITS} bits: {word}")
    return Instr(
        const=(word >> 11) & 0xF,
        stream=(word >> 7) & 0xF,
        shdir=(word >> 6) & 0x1,
        shamt=(word >> 3) & 0x7,
        clear_acc=bool((word >> 2) & 1),
        enable_out=bool((word >> 1) & 1),
        advance=bool(word & 1),
    )


@dataclasses.dataclass(frozen=True)
class Program:
    """An assembled Casper program: instructions + stream/constant tables.

    ``boundary`` (recorded on the stream plan) is the source spec's
    boundary mode — instruction semantics are boundary-free (streams
    serve whatever the runtime maps under them), but the software SPU VM
    needs it to serve out-of-grid stream elements the same way the
    oracles do.
    """

    spec_name: str
    plan: StreamPlan
    instrs: tuple[Instr, ...]

    @property
    def boundary(self) -> str:
        return self.plan.boundary

    @property
    def structure(self) -> str:
        """Tap-structure class of the source spec (recorded on the
        stream plan): star / separable / dense."""
        return self.plan.structure

    @property
    def words(self) -> tuple[int, ...]:
        return tuple(i.encode() for i in self.instrs)

    @property
    def n_instrs(self) -> int:
        return len(self.instrs)

    @property
    def structured_n_instrs(self) -> int:
        """Per-point instruction count of the structure-specialized
        compute (the factored MAC count from the stream plan); equals
        ``n_instrs`` for dense/star programs, smaller when a separable
        box was factored (e.g. 15 vs 33 for ``star33_3d``)."""
        return self.plan.structured_ops or self.n_instrs

    def dynamic_instruction_count(
        self, points: int, n_spus: int = 16, vector_width: int = 8,
        structured: bool = False,
    ) -> dict[str, int]:
        """Dynamic instruction counts, Table 4 methodology.

        Each SPU instruction covers ``vector_width`` output points (512-bit /
        f64).  Points are split evenly across SPUs.  ``structured=True``
        counts the factored op sequence (``structured_n_instrs``) instead
        of the dense tap list — what an SPU executing the
        structure-specialized program would retire; the default stays
        dense for like-for-like comparison against the paper's Table 4.
        """
        n = self.structured_n_instrs if structured else self.n_instrs
        per_spu_points = -(-points // n_spus)
        per_spu_vectors = -(-per_spu_points // vector_width)
        per_spu = per_spu_vectors * n
        return {
            "per_spu": per_spu,
            "total": per_spu * n_spus,
            "scalar_equivalent": points * n,
        }

    def loads_per_vector(self) -> dict[str, int]:
        """Aligned vs unaligned loads per 8-element output vector.

        With the unaligned-load hardware (paper §4.1) every tap is one load;
        without it a shifted tap costs two line loads plus shift+combine —
        the paper's 6-vs-4 loads example of Fig. 4.
        """
        aligned = sum(1 for i in self.instrs if i.shamt == 0)
        unaligned = sum(1 for i in self.instrs if i.shamt != 0)
        return {
            "with_casper": aligned + unaligned + 1,         # +1 output store
            "without_casper": aligned + 2 * unaligned + 1,
            "unaligned": unaligned,
        }


@dataclasses.dataclass(frozen=True)
class PipelineProgram:
    """The SPU program of a :class:`~repro_torch.core.stencil.StencilPipeline`:
    one assembled :class:`Program` per stage, dispatched back-to-back per
    grid pass (the host broadcasts each stage's instruction buffer in
    turn — the 64-entry buffer bounds one *stage*, not the chain).

    Aggregate accounting (``n_instrs`` / ``dynamic_instruction_count`` /
    ``loads_per_vector``) sums the per-stage numbers, so pipeline
    programs report Table-4-style counts for one full chain application.
    """

    spec_name: str
    stages: tuple[Program, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def plans(self) -> tuple[StreamPlan, ...]:
        """Per-stage stream plans (a pipeline has no single plan)."""
        return tuple(p.plan for p in self.stages)

    @property
    def words(self) -> tuple[int, ...]:
        return tuple(w for p in self.stages for w in p.words)

    @property
    def n_instrs(self) -> int:
        return sum(p.n_instrs for p in self.stages)

    @property
    def structured_n_instrs(self) -> int:
        return sum(p.structured_n_instrs for p in self.stages)

    def dynamic_instruction_count(
        self, points: int, n_spus: int = 16, vector_width: int = 8,
        structured: bool = False,
    ) -> dict[str, int]:
        """Key-wise sum of the per-stage Table 4 counts: every stage
        makes one full grid pass of its own program."""
        out: dict[str, int] = {}
        for p in self.stages:
            for key, v in p.dynamic_instruction_count(
                    points, n_spus, vector_width, structured).items():
                out[key] = out.get(key, 0) + v
        return out

    def loads_per_vector(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for p in self.stages:
            for key, v in p.loads_per_vector().items():
                out[key] = out.get(key, 0) + v
        return out


def assemble_pipeline(pipeline: StencilPipeline) -> PipelineProgram:
    """StencilPipeline -> per-stage Casper programs (each stage respects
    the 64-entry instruction buffer on its own)."""
    return PipelineProgram(
        spec_name=pipeline.name,
        stages=tuple(assemble(s) for s in pipeline.stages))


def assemble_any(spec):
    """Assemble either spec kind: the dispatch point the lowering
    pipeline and the engine use."""
    if isinstance(spec, StencilPipeline):
        return assemble_pipeline(spec)
    return assemble(spec)


def assemble(spec: StencilSpec) -> Program:
    """StencilSpec -> Casper program (the paper's programming library)."""
    plan = plan_streams(spec)
    last_use_of_stream: dict[int, int] = {}
    for pos, tap in enumerate(plan.taps):
        last_use_of_stream[tap.stream] = pos

    instrs: list[Instr] = []
    for pos, tap in enumerate(plan.taps):
        instrs.append(
            Instr(
                const=plan.const_index(tap.coeff),
                stream=tap.stream,
                shdir=1 if tap.shift < 0 else 0,
                shamt=abs(tap.shift),
                clear_acc=(pos == 0),
                enable_out=(pos == len(plan.taps) - 1),
                advance=(last_use_of_stream[tap.stream] == pos),
            )
        )
    if len(instrs) > 64:
        raise ValueError(
            f"{spec.name}: {len(instrs)} instructions exceed the 64-entry "
            "instruction buffer")
    return Program(spec_name=spec.name, plan=plan, instrs=tuple(instrs))
