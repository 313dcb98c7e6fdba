"""Software SPU: executes an assembled Casper program (semantic model).

The port's counterpart of ``repro.core.vm``, in torch on the tensor's
own device, so that ``backend="vm"`` runs on the card.  Every grid point
runs the identical instruction sequence (paper §3.2), so the VM executes
instruction by instruction *vectorized over all grid points at once* —
semantically identical to the per-point sequential SPU.

Out-of-grid stream elements are served per the program's boundary mode
(zero / constant(c) / periodic / reflect): ghost addresses map to the
fill value or to the wrapped / mirrored interior element, as the oracles
do.  The VM executes the *dense* tap program, one MAC per tap — the
literal semantics of the paper's SPU — so it matches the factored
oracles to f64 rounding (the reference pins ``atol=1e-12``), and matches
``repro.core.vm`` bit for bit: each instruction is one product
``coeff * value`` and, unless it clears the accumulator, one separate
add.  The two stay separate tensor operations (never ``torch.add`` with
``alpha``, ``addcmul`` or another fused form), so no multiply-add is
contracted on the card.

The VM also keeps the event counters (loads by alignment, stores, MACs,
instructions) that feed the paper's performance and energy model
(:mod:`repro_torch.core.perfmodel`); they are Python ints equal to the
reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from .isa import Program
from .ref import periodic_index, reflect_index
from .stencil import StencilSpec, parse_boundary


@dataclasses.dataclass
class SpuCounters:
    instructions: int = 0      # dynamic vector instructions (all SPUs)
    loads_aligned: int = 0     # vector loads with shamt == 0
    loads_unaligned: int = 0   # vector loads needing the §4.1 mechanism
    stores: int = 0
    macs: int = 0              # scalar MAC operations

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


def _shifted(grid: torch.Tensor, offset: tuple[int, ...],
             mode: str = "zero", value: float = 0.0) -> torch.Tensor:
    """Boundary-extended shifted view: value of in[p + offset] for all p,
    with out-of-grid elements served per the boundary ``mode``."""
    if mode in ("periodic", "reflect"):
        fold = periodic_index if mode == "periodic" else reflect_index
        out = grid
        for d, (o, n) in enumerate(zip(offset, grid.shape)):
            idx = fold(torch.arange(n, device=grid.device) + o, n)
            out = out.index_select(d, idx)
        return out
    fill = value if mode == "constant" else 0.0
    out = torch.full_like(grid, fill)
    src = []
    dst = []
    for o, n in zip(offset, grid.shape):
        if o >= 0:
            src.append(slice(o, n))
            dst.append(slice(0, n - o))
        else:
            src.append(slice(0, n + o))
            dst.append(slice(-o, n))
    out[tuple(dst)] = grid[tuple(src)]
    return out


class SpuVM:
    """Executes a Casper program over a grid; counts events."""

    def __init__(self, program: Program, vector_width: int = 8,
                 n_spus: int = 16):
        self.program = program
        self.vector_width = vector_width
        self.n_spus = n_spus
        self.counters = SpuCounters()

    def run(self, grid: torch.Tensor) -> torch.Tensor:
        prog = self.program
        plan = prog.plan
        mode, fill = parse_boundary(prog.boundary)
        stream_base = {s.index: s.base for s in plan.streams}
        acc = torch.zeros_like(grid)
        out = torch.zeros_like(grid)
        size = grid.numel()
        n_vectors = -(-size // self.vector_width)

        for instr in prog.instrs:
            base = stream_base[instr.stream]
            offset = base[:-1] + (base[-1] + instr.shift,)
            value = _shifted(grid, offset, mode, fill)
            coeff = plan.consts[instr.const]
            if instr.clear_acc:
                acc = coeff * value
            else:
                acc = acc + coeff * value
            if instr.enable_out:
                out = acc.clone()
                self.counters.stores += n_vectors
            self.counters.instructions += n_vectors
            if instr.shamt == 0:
                self.counters.loads_aligned += n_vectors
            else:
                self.counters.loads_unaligned += n_vectors
            self.counters.macs += size
        return out

    def run_iterations(self, grid: torch.Tensor, iters: int) -> torch.Tensor:
        g = grid
        for _ in range(iters):
            g = self.run(g)
        return g


def _merge_counters(parts: list[SpuCounters]) -> SpuCounters:
    total = SpuCounters()
    for c in parts:
        for f in dataclasses.fields(SpuCounters):
            setattr(total, f.name,
                    getattr(total, f.name) + getattr(c, f.name))
    return total


def execute_plan(plan, grid: torch.Tensor,
                 iters: int | None = None
                 ) -> tuple[torch.Tensor, SpuCounters]:
    """SPU-VM executor of one lowered ``"vm"`` plan: runs the plan's
    assembled program for ``iters`` (default ``plan.sweeps``)
    applications on ``grid``'s device, serving out-of-grid stream
    elements per the plan's boundary mode (ghost strategy ``"stream"``).

    A pipeline plan carries a ``PipelineProgram``: each chain application
    runs the stage programs back to back (one :class:`SpuVM` per stage);
    the counters returned are the sum over every stage run."""
    if plan.backend != "vm":
        raise ValueError(f"not a vm plan: backend={plan.backend!r}")
    n = plan.sweeps if iters is None else iters
    if plan.is_pipeline:
        vms = [SpuVM(p) for p in plan.program.stages]
        g = grid
        for _ in range(n):
            for vm in vms:
                g = vm.run(g)
        return g, _merge_counters([vm.counters for vm in vms])
    vm = SpuVM(plan.program)
    out = vm.run_iterations(grid, n)
    return out, vm.counters


def run_program(spec: StencilSpec, grid: torch.Tensor,
                iters: int = 1) -> tuple[torch.Tensor, SpuCounters]:
    """``iters`` applications of ``spec``'s program to ``grid`` on its
    own device, with the counters."""
    from .plan import lower   # plan imports the executors lazily
    plan = lower(spec, grid.shape, grid.dtype, backend="vm",
                 device=grid.device)
    return execute_plan(plan, grid, iters)
