"""Per-device cost walker over a traced graph of local ops.

The counterpart of the reference's ``roofline/hlo_walk.py`` (and
``hlo.py``), which walks the partitioned HLO of a compiled XLA module.
Here the module is a ``torch.fx`` graph from ``make_fx(fn,
tracing_mode="fake")``: on a mesh, ``fn`` wraps local shards with
``DTensor.from_local`` and its graph holds the ops each rank runs on its
own blocks plus DTensor's explicit ``_c10d_functional`` collectives, the
torch form of a partitioned module.  :func:`walk` returns per-device
totals:

    flops        ``torch.utils.flop_counter``'s registry (matmuls,
                 attention, convolutions) on each node's local shapes,
                 the count ``FlopCounterMode`` gives a plain function
    bytes        per node, operands plus result; views, ``getitem``,
                 ``detach``, ``wait_tensor`` and ``empty`` are free (the
                 reference's per-instruction model with nothing fused,
                 as eager PyTorch fuses nothing)
    collectives  per kind: count, operand bytes, group size (from the
                 node's group argument), wire bytes with the reference's
                 ring multipliers, and the slowest link the group crosses
                 (NVLink inside a node of ``ranks_per_node`` consecutive
                 ranks, by default ``analysis.RANKS_PER_NODE``, the
                 network across nodes)
    memory       a liveness walk over storages in graph order (eager
                 PyTorch runs in the order it was traced, so this models
                 the caching allocator's live bytes): argument, output,
                 alias (outputs that are arguments updated in place) and
                 temp bytes, and the peak

Two shortcuts do not work and are not used: ``FlopCounterMode`` around
DTensor code counts global FLOPs, and a ``TorchDispatchMode`` around it
sees DTensor-level ops but not the local compute DTensor issues.  Send
and recv count under the reference's ``collective-permute``.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any

import torch

from .analysis import RANKS_PER_NODE

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (namespace-less, overload-less) -> collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
# ops that move no bytes (besides views, which ``OpOverload.is_view`` marks)
_FREE = {"detach", "wait_tensor", "_unsafe_view", "alias", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "lift_fresh", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "_local_scalar_dense"}


def _wire_multiplier(kind: str, g: int) -> float:
    """Bytes on the wire per operand byte of a ring collective over ``g``
    ranks (the reference's multipliers)."""
    if g <= 1:
        return 0.0
    return {"all-reduce": 2.0 * (g - 1) / g,
            "all-gather": float(g - 1),
            "reduce-scatter": (g - 1) / g,
            "all-to-all": (g - 1) / g,
            "collective-permute": 1.0}.get(kind, 1.0)


@dataclasses.dataclass
class Totals:
    """Per-device totals of one traced step (``hlo_walk.Totals``'s
    fields, plus wire bytes per link and the memory split)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_operand: dict = dataclasses.field(default_factory=dict)
    coll_wire: dict = dataclasses.field(default_factory=dict)
    coll_count: dict = dataclasses.field(default_factory=dict)
    coll_link: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "Totals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for d_self, d_o in ((self.coll_operand, other.coll_operand),
                            (self.coll_wire, other.coll_wire),
                            (self.coll_count, other.coll_count),
                            (self.coll_link, other.coll_link),
                            (self.memory, other.memory)):
            for k, v in d_o.items():
                d_self[k] = d_self.get(k, 0.0) + v * mult

    def extended(self, step: "Totals", repeats: int) -> "Totals":
        """These totals plus ``repeats`` times (``step`` - these): a
        graph traced at one depth and at one period deeper, carried to
        the full depth (the reference multiplies a scanned body by its
        trip count)."""
        out = Totals()
        out.add(self)
        out.add(step, repeats)
        out.add(self, -repeats)
        return out

    @property
    def collective_wire_bytes(self) -> float:
        return sum(self.coll_wire.values())

    def collective_ops(self) -> dict:
        return {k: {"count": self.coll_count.get(k, 0.0),
                    "operand_bytes": self.coll_operand.get(k, 0.0),
                    "wire_bytes": self.coll_wire.get(k, 0.0)}
                for k in self.coll_wire}


def _name(target) -> str:
    if target is operator.getitem:
        return "getitem"
    name = getattr(target, "__name__", str(target))
    return name.split(".")[0]


def _tensors(x) -> list:
    """The tensors in a node value or argument (nested lists/tuples)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _val(x, gm=None):
    """A node argument with every fx ``Node`` replaced by its value (a
    ``get_attr`` node's from ``gm``: the process groups of c10d ops)."""
    if isinstance(x, torch.fx.Node):
        if x.op == "get_attr" and gm is not None:
            return getattr(gm, x.target)
        return x.meta.get("val")
    if isinstance(x, (list, tuple)):
        return type(x)(_val(v, gm) for v in x)
    if isinstance(x, dict):
        return {k: _val(v, gm) for k, v in x.items()}
    return x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef
    s = t.untyped_storage()
    return StorageWeakRef(s), s.nbytes()


def _process_group(a):
    """The process group argument ``a`` names, or ``None``: a group name
    (the functional collectives), a ``ProcessGroup``, or one boxed as a
    ``ScriptObject`` (the c10d ops ``dist.all_reduce`` and its kind
    dispatch)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if isinstance(a, str):
        try:
            return _resolve_process_group(a)
        except Exception:
            return None
    if isinstance(a, dist.ProcessGroup):
        return a
    if isinstance(a, torch.ScriptObject):
        try:
            return dist.ProcessGroup.unbox(a)
        except Exception:
            return None
    return None


def _group(args: tuple, kwargs: dict):
    """(size, global ranks) of a collective's group, read from its
    arguments (the last that names one)."""
    import torch.distributed as dist
    for a in list(kwargs.values())[::-1] + list(args)[::-1]:
        pg = _process_group(a)
        if pg is not None:
            return pg.size(), dist.get_process_group_ranks(pg)
    return None, None


def link_of(ranks, ranks_per_node: int) -> str:
    """The slowest link a group of global ``ranks`` crosses."""
    return ("nvlink" if len({r // ranks_per_node for r in ranks}) <= 1
            else "network")


def flops_of(node: torch.fx.Node) -> float:
    """The registry's FLOPs of one call node on its (local) shapes."""
    from torch.utils.flop_counter import flop_registry
    packet = getattr(node.target, "overloadpacket", None)
    fn = flop_registry.get(packet) if packet is not None else None
    if fn is None:
        return 0.0
    return float(fn(*_val(node.args), **_val(node.kwargs),
                    out_val=node.meta.get("val")))


def memory_split(gm: torch.fx.GraphModule, free: bool = True) -> dict:
    """Liveness over storages in graph order: a storage lives from the
    node that first yields it (arguments: the whole call) to its last use
    by any alias; outputs live to the end.  Each node's results are
    allocated while its operands still live.  ``free=False`` never frees
    (a bound, and the planted fault of ``chip_smoke.py`` phase 2m)."""
    nodes = list(gm.graph.nodes)
    size, first, last = {}, {}, {}
    args, outs = set(), set()
    for i, n in enumerate(nodes):
        if n.op == "output":
            for t in _tensors(_val(n.args)):
                outs.add(_storage(t)[0])
            continue
        for t in _tensors(n.meta.get("val")):
            key, nb = _storage(t)
            size[key] = max(size.get(key, 0), nb)
            first.setdefault(key, i)
            last[key] = max(last.get(key, i), i)
            if n.op == "placeholder":
                args.add(key)
        for inp in n.all_input_nodes:
            for t in _tensors(inp.meta.get("val")):
                key = _storage(t)[0]
                last[key] = max(last.get(key, i), i)
    end = len(nodes)
    for key in (outs | args) if free else last:
        last[key] = end
    born = {}
    for key, i in first.items():
        born.setdefault(i, []).append(key)
    dies = {}
    for key, i in last.items():
        dies.setdefault(i, []).append(key)
    arg_bytes = sum(size[k] for k in args)
    live, temp, peak, temp_peak = arg_bytes, 0, arg_bytes, 0
    for i in range(end):
        for key in born.get(i, ()):
            if key in args:
                continue
            live += size[key]
            if key not in outs:
                temp += size[key]
        peak = max(peak, live)
        temp_peak = max(temp_peak, temp)
        for key in dies.get(i, ()):
            if key in args or key in outs:
                continue
            live -= size[key]
            temp -= size[key]
    return {"argument_size_in_bytes": float(arg_bytes),
            "output_size_in_bytes": float(sum(size.get(k, 0)
                                              for k in outs - args)),
            "alias_size_in_bytes": float(sum(size[k] for k in outs & args)),
            "temp_size_in_bytes": float(temp_peak),
            "peak_bytes": float(peak)}


def walk(gm: torch.fx.GraphModule, n_devices: int, *,
         ranks_per_node: int = RANKS_PER_NODE) -> Totals:
    """Per-device totals of ``gm`` (a ``make_fx`` graph of local ops)."""
    t = Totals()
    for n in gm.graph.nodes:
        if n.op != "call_function":
            continue
        name = _name(n.target)
        kind = _COLLECTIVE_OPS.get(name)
        res = _tensors(n.meta.get("val"))
        if kind is not None:
            args = _val(n.args, gm)
            ops = _tensors(args)
            ob = float(sum(_nbytes(x) for x in ops))
            g, ranks = _group(args, _val(n.kwargs, gm))
            if g is None:
                g, ranks = n_devices, range(n_devices)
            wire = ob * _wire_multiplier(kind, g)
            t.coll_operand[kind] = t.coll_operand.get(kind, 0.0) + ob
            t.coll_wire[kind] = t.coll_wire.get(kind, 0.0) + wire
            t.coll_count[kind] = t.coll_count.get(kind, 0.0) + 1
            link = link_of(ranks, ranks_per_node)
            t.coll_link[link] = t.coll_link.get(link, 0.0) + wire
            t.bytes += ob + sum(_nbytes(x) for x in res)
            continue
        if name in _FREE or name == "getitem" or getattr(
                n.target, "is_view", False):
            continue
        t.flops += flops_of(n)
        t.bytes += float(sum(_nbytes(x) for x in _tensors(_val(n.args)))
                         + sum(_nbytes(x) for x in res))
    t.memory = memory_split(gm)
    return t


def trace(fn, *args) -> torch.fx.GraphModule:
    """``make_fx(fn, tracing_mode="fake")(*args)``: the graph of local
    ops ``fn`` runs (fake tensors: shapes only, no storage)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn, tracing_mode="fake")(*args)


def walk_fn(fn, *args, n_devices: int = 1) -> Totals:
    """Trace ``fn(*args)`` and walk its graph (the reference's
    ``walk_jit``).  ``args`` may be real or fake tensors."""
    return walk(trace(fn, *args), n_devices)


def count_nodes(gm: torch.fx.GraphModule) -> dict[str, Any]:
    """Call nodes by op name (for logs and tests)."""
    out: dict[str, int] = {}
    for n in gm.graph.nodes:
        if n.op == "call_function":
            k = _name(n.target)
            out[k] = out.get(k, 0) + 1
    return out
