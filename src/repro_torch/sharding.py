"""Logical-axis sharding: the bridge from model code to mesh axes.

Model code annotates parameters and activations with *logical* axes, as
the reference's does; this module resolves them onto a mesh.  Every
tensor axis is split into contiguous blocks per device, so communication
happens only at block boundaries (collectives), never per element.

Logical axes:
  dp    data parallel (batch dim)                -> ("pod", "data")
  fsdp  fully-sharded parameter dim              -> ("pod", "data")
  tp    tensor parallel (heads / ffn / vocab)    -> "model"
  ep    expert parallel (MoE expert dim)         -> "model"
  sp    sequence parallel (long-context KV/state)-> "data"
  seq   the residual stream's sequence dim       -> "model"

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's dim
names, ``("data", "model")`` or ``("pod", "data", "model")``, or, where
only shapes are asked for (the dry run), a :class:`MeshShape`: the names
and sizes with no process group.  :func:`resolve` turns logical axes into
a :class:`PartitionSpec` (the reference's ``P``) and :func:`placements`
turns that into DTensor placements: a mesh dim that a tensor dim names
gets ``Shard(d)``, every other one ``Replicate()``.  A tuple entry such
as ``("pod", "data")`` shards one tensor dim over both mesh dims, major
first, as JAX does.

:class:`ShardCtx` is carried through model code.  With ``mesh=None``
every constraint is the identity, so model code is mesh-agnostic; with a
``DeviceMesh`` the params are DTensors (:func:`~repro_torch.models.common.
init_params` with ``mesh=``), :meth:`ShardCtx.constrain` is
``redistribute`` (it moves data and never changes a value), and the
model's entry points (:func:`~repro_torch.models.registry.make_arch`) run
under :func:`on_mesh`, where a plain tensor met beside a DTensor (a
position range, a mask, a zero) counts as replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Sequence

import torch


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, a mesh axis name, or a tuple of names
    (the reference's ``jax.sharding.PartitionSpec``; a one-name tuple is
    the name, as there)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes, with no devices or process group
    (the reference's ``AbstractMesh``)."""

    shape_tuple: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape_tuple) != len(self.axis_names):
            raise ValueError(f"{self.shape_tuple} vs {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape_tuple))

    @property
    def size(self) -> int:
        return math.prod(self.shape_tuple)


def axis_names(mesh) -> tuple[str, ...]:
    """The dim names of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs dim names ('data', 'model'[, "
                         "'pod'])")
    return tuple(names)


def axis_size(mesh, name: str) -> int:
    if isinstance(mesh, MeshShape):
        return mesh.shape[name]
    return mesh.size(axis_names(mesh).index(name))


def _mesh_axes(mesh, logical: str) -> Any:
    has_pod = "pod" in axis_names(mesh)
    table = {
        "dp": ("pod", "data") if has_pod else ("data",),
        "fsdp": ("pod", "data") if has_pod else ("data",),
        "tp": "model",
        "ep": "model",
        "sp": "data",
        # Megatron-style sequence parallelism: the residual stream's seq
        # dim shards over the TP group between attention/MLP regions
        "seq": "model",
    }
    return table[logical]


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve(mesh, logical: Sequence[str | None],
            shape: Sequence[int] | None = None,
            overrides: dict | None = None) -> PartitionSpec:
    """Logical axis names -> :class:`PartitionSpec` on ``mesh`` (a
    ``DeviceMesh`` or a :class:`MeshShape`).

    With ``shape``, axes that do not divide the dimension are dropped
    (replicated): 4 KV heads on 16-way TP replicate, Megatron-style;
    batch-1 long-context cells replicate the batch dim.  ``overrides``
    remap logical axes (``{"fsdp": None}`` for TP-only serving params).
    """
    entries = []
    for d, a in enumerate(logical):
        if overrides and a in overrides:
            a = overrides[a]
        if a is None:
            entries.append(None)
            continue
        axes = _mesh_axes(mesh, a)
        if shape is not None:
            size = math.prod(axis_size(mesh, ax) for ax in _names(axes))
            if shape[d] % size != 0:
                entries.append(None)
                continue
        entries.append(axes)
    return PartitionSpec(*entries)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d`` names the mesh dim, else
    ``Replicate()``.  A tensor dim named by several mesh dims is split
    over them in mesh order, major first; the names of a tuple entry
    must come in that order.  A mesh dim of size 1 replicates (its one
    shard is the whole; DTensor refuses some views of such a shard)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(n) for n in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{entry!r} is not in the mesh's order "
                             f"{names}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh dim {names[j]!r} shards two "
                                 f"tensor dims in {spec!r}")
            if axis_size(mesh, names[j]) > 1:
                out[j] = Shard(d)
    return tuple(out)


def shard_shape(mesh, spec: Sequence, shape: Sequence[int]
                ) -> tuple[int, ...]:
    """The largest shard of a ``shape`` tensor under ``spec`` (every
    shard where the mesh sizes divide ``shape``), as
    ``NamedSharding.shard_shape`` gives it."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(axis_size(mesh, a) for a in _names(entry))
        out[d] = -(-out[d] // n)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (the reference's
    ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return shard_shape(self.mesh, self.spec, shape)


def is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, MeshShape)


def local_chunk(full: torch.Tensor, mesh, places: Sequence) -> torch.Tensor:
    """This rank's block of ``full`` under ``places`` (a view)."""
    rg = block_ranges(full.shape, mesh, places, mesh.get_coordinate())
    return _cut(full, rg, [(0, n) for n in full.shape])


def block_start(t, dim: int) -> int:
    """The global index of the first position of this rank's block of
    DTensor ``t`` along ``dim``."""
    return block_ranges(t.shape, t.device_mesh, t.placements,
                        t.device_mesh.get_coordinate())[dim][0]


def distribute(full: torch.Tensor, mesh, places: Sequence):
    """A DTensor of ``full`` (present whole in every rank) that keeps
    only this rank's block: no communication."""
    part = local_chunk(full, mesh, places).clone(
        memory_format=torch.contiguous_format)   # frees ``full``'s storage
    return from_local(part, mesh, places, full.shape)


# ---------------------------------------------------------------------------
# moving blocks between layouts (remesh, checkpoints)
# ---------------------------------------------------------------------------
def block_ranges(shape: Sequence[int], mesh, places: Sequence,
                 coord: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """The [start, stop) per tensor dim of the block that the rank at
    ``coord`` of ``mesh`` holds under ``places`` (``torch.chunk`` per
    mesh dim, in mesh order: DTensor's layout)."""
    from torch.distributed.tensor import Shard
    ranges = [(0, n) for n in shape]
    for j, pl in enumerate(places):
        if isinstance(pl, Shard):
            lo, hi = ranges[pl.dim]
            chunk = -(-(hi - lo) // mesh.size(j))
            a = min(lo + coord[j] * chunk, hi)
            ranges[pl.dim] = (a, min(a + chunk, hi))
    return tuple(ranges)


class Layout:
    """Which block of a ``shape`` tensor each global rank holds: a
    DTensor's (``mesh`` and ``places``), or the whole tensor on one rank
    (``owner``) and nothing elsewhere."""

    def __init__(self, shape, mesh=None, places=None, owner=None):
        self.shape = tuple(shape)
        self.mesh, self.places, self.owner = mesh, places, owner
        if mesh is not None:
            grid = mesh.mesh
            self.coords = {int(grid[idx]): idx for idx in
                           itertools.product(*(range(n)
                                               for n in grid.shape))}

    def ranges(self, rank: int):
        if self.mesh is None:
            return (tuple((0, n) for n in self.shape)
                    if rank == self.owner else None)
        if rank not in self.coords:
            return None
        return block_ranges(self.shape, self.mesh, self.places,
                            self.coords[rank])


def _plan(src: Layout, dst: Layout, world: int):
    """(source rank, destination rank, region) of every piece: each
    region of a destination block comes from the one holder of it that
    is the destination itself if it holds it, else one chosen by the
    destination's rank among the holders (replicas share the sends)."""
    holders: dict = {}
    for r in range(world):
        rg = src.ranges(r)
        if rg is not None and all(b > a for a, b in rg):
            holders.setdefault(rg, []).append(r)
    pieces = []
    for t in range(world):
        want = dst.ranges(t)
        if want is None:
            continue
        for rg, hs in holders.items():
            inter = tuple((max(a, c), min(b, d))
                          for (a, b), (c, d) in zip(rg, want))
            if any(b <= a for a, b in inter):
                continue
            s = t if t in hs else hs[t % len(hs)]
            pieces.append((s, t, inter, rg, want))
    return pieces


def _cut(t: torch.Tensor, inter, base) -> torch.Tensor:
    for d, ((a, b), (lo, _)) in enumerate(zip(inter, base)):
        t = t.narrow(d, a - lo, b - a)
    return t


def move_blocks(local: torch.Tensor | None, src: Layout, dst: Layout, *,
                dtype: torch.dtype, device, group=None):
    """This rank's block under ``dst`` from every rank's block under
    ``src`` (``local``: this rank's, or ``None`` where it holds none), in
    one all-to-all over ``group`` (default: the world) whose pieces are
    the blocks' overlaps; each piece crosses once, through host memory
    (pinned where a side is on a CUDA device: gloo's own path for CUDA
    tensors is not taken).  ``local`` may sit on another device than
    the result's ``device`` (a leaf read from disk stays on the host).
    Every rank of the group calls it with the same layouts."""
    import torch.distributed as dist
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    pieces = _plan(src, dst, world)
    send = [[] for _ in range(world)]
    for s, t, inter, base, _ in pieces:
        if s == rank and t != rank:
            send[t].append(_cut(local, inter, base).reshape(-1))
    sizes_out = [sum(x.numel() for x in parts) for parts in send]
    sizes_in = [0] * world
    for s, t, inter, _, _ in pieces:
        if t == rank and s != rank:
            sizes_in[s] += math.prod(b - a for a, b in inter)
    host_out = torch.empty(sum(sizes_out), dtype=dtype,
                           pin_memory=local is not None
                           and local.device.type == "cuda")
    at = 0
    for parts in send:
        for x in parts:
            host_out[at:at + x.numel()].copy_(x)
            at += x.numel()
    del send
    host_in = torch.empty(sum(sizes_in), dtype=dtype,
                          pin_memory=torch.device(device).type == "cuda")
    if world > 1:
        dist.all_to_all_single(host_in, host_out, sizes_in, sizes_out,
                               group=group)
    del host_out
    want = dst.ranges(rank)
    if want is None:
        return None
    out = torch.empty(tuple(b - a for a, b in want), dtype=dtype,
                      device=device)
    offsets, acc = {}, 0
    for r in range(world):
        offsets[r] = acc
        acc += sizes_in[r]
    for s, t, inter, base, _ in pieces:
        if t != rank:
            continue
        region = _cut(out, inter, want)
        if s == rank:
            region.copy_(_cut(local, inter, base))
        else:
            n = region.numel()
            region.copy_(host_in[offsets[s]:offsets[s] + n].view(
                region.shape))
            offsets[s] += n
    return out


def layout_of(x) -> Layout:
    """The :class:`Layout` of a DTensor."""
    return Layout(x.shape, x.device_mesh, tuple(x.placements))


def to_mesh(x, mesh, places: Sequence):
    """DTensor ``x`` on another ``mesh`` of the same world, as
    ``places`` say: each rank receives only the pieces of its new block
    that it does not hold (:func:`move_blocks`)."""
    dst = Layout(x.shape, mesh, tuple(places))
    block = move_blocks(x.to_local(), layout_of(x), dst, dtype=x.dtype,
                        device=x.to_local().device)
    if block is None:                  # a rank outside ``mesh``
        return None
    return from_local(block, mesh, places, x.shape)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def from_local(t: torch.Tensor, mesh, places: Sequence, shape=None):
    """A DTensor whose local part on this rank is ``t`` (no check across
    ranks; differentiable); ``shape``: its global shape where the blocks
    are uneven."""
    from torch.distributed.tensor import DTensor
    if shape is None:
        return DTensor.from_local(t, mesh, tuple(places), run_check=False)
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(t, mesh, tuple(places), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor (which every rank
    holds whole) is taken as replicated."""
    from torch.distributed.tensor import Replicate
    if is_dtensor(x):
        return x
    return from_local(x, mesh, [Replicate()] * mesh.ndim)


def whole_along(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with tensor dims ``dims`` unsharded (a DTensor sharded along
    one of them is redistributed; anything else is returned as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % x.ndim for d in dims} if x.ndim else set()
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim in dims
                 else pl for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole: a DTensor is gathered (a collective every rank of its
    mesh joins); a plain tensor is returned as it is."""
    return x.full_tensor() if is_dtensor(x) else x


_ROUTED: dict[str, Any] = {}       # device type -> the Library holding it


def route_gloo_gathers(device_type: str = "cuda") -> None:
    """Send DTensor's all-gathers of ``device_type`` tensors through
    ``torch.distributed.all_gather_into_tensor`` on the group.

    On the card (torch 2.11), a gloo group carries every collective that
    DTensor issues for CUDA tensors when it is called directly, but the
    functional all-gather (``_c10d_functional.all_gather_into_tensor``,
    which Shard -> Replicate and ``full_tensor`` use) kills the process
    with a segmentation fault (``tools/gloo_cuda_probe.py``).  This
    registers the op's kernel for ``device_type`` anew (and its ``_out``
    and ``_coalesced`` forms) as the direct call, which gloo stages
    through host memory itself; the values are the same gather.  Once per
    process and device type; the meshes of :mod:`repro_torch.launch.mesh`
    call it for CUDA meshes over gloo."""
    if device_type in _ROUTED:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def group_of(name):
        return name if isinstance(name, dist.ProcessGroup) else \
            _resolve_process_group(name)

    def gather_out(inp, group_size, group_name, *, out):
        inp = inp.reshape(1) if inp.dim() == 0 else inp.contiguous()
        dist.all_gather_into_tensor(out, inp, group=group_of(group_name))
        return out

    def gather(inp, group_size, group_name):
        shape = tuple(inp.shape) or (1,)
        out = inp.new_empty((group_size * shape[0],) + shape[1:])
        return gather_out(inp, group_size, group_name, out=out)

    def gather_coalesced(inputs, group_size, group_name):
        return [gather(t, group_size, group_name) for t in inputs]

    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, key)
    lib.impl("all_gather_into_tensor_out", gather_out, key)
    lib.impl("all_gather_into_tensor_coalesced", gather_coalesced, key)
    _ROUTED[device_type] = lib


_COMPUTE: dict[int, tuple] = {}     # id(pod mesh) -> (mesh, its 2-D view)


def compute_mesh(mesh):
    """The mesh model code computes on: ``mesh`` itself, or for a
    ``("pod", "data", "model")`` mesh a 2-D ``("data", "model")`` mesh
    of the same ranks with pod and data flattened, major first.

    A rank's block of a tensor sharded over ("pod", "data") on the pod
    mesh is its block over the flattened dim, so moving a DTensor
    between the two is a re-view of its local part.  Params and
    optimizer state live on the pod mesh, placed as the reference's
    specs say; activations, caches and batches on the 2-D view (where
    ``sp``, "data" alone on the pod mesh, spans the flattened dim).
    DTensor's strategy search for one product with a tensor dim sharded
    over two mesh dims takes about a minute (torch 2.13), which this
    avoids.  Built once per mesh, on first use, by every rank
    (``DeviceMesh`` is collective)."""
    if not is_device_mesh(mesh) or "pod" not in axis_names(mesh):
        return mesh
    if id(mesh) not in _COMPUTE:
        from torch.distributed.device_mesh import DeviceMesh
        ranks = mesh.mesh.reshape(-1, axis_size(mesh, "model"))
        _COMPUTE[id(mesh)] = (mesh, DeviceMesh(
            mesh.device_type, ranks, mesh_dim_names=("data", "model")))
    return _COMPUTE[id(mesh)][1]


_MESH_SCOPES = [0]          # nesting depth of on_mesh


@contextlib.contextmanager
def on_mesh():
    """The scope model code on a mesh runs in: a plain tensor beside a
    DTensor counts as replicated (DTensor's ``implicit_replication``).
    Nested scopes are one scope (``implicit_replication`` itself turns
    the switch off when any scope ends)."""
    if _MESH_SCOPES[0]:
        _MESH_SCOPES[0] += 1
        try:
            yield
        finally:
            _MESH_SCOPES[0] -= 1
        return
    try:
        from torch.distributed.tensor.experimental import \
            implicit_replication
    except ImportError:                # a torch built without distributed
        yield
        return
    _MESH_SCOPES[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _MESH_SCOPES[0] -= 1


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Carried through model code; resolves logical constraints.

    ``mesh=None`` (one device) turns every constraint into the identity,
    so model code is mesh-agnostic.  ``overrides`` remap logical axes
    (e.g. ``{"fsdp": None}`` for TP-only serving).
    """

    mesh: Any = None
    overrides: dict | None = None

    @property
    def cmesh(self):
        """The mesh activations live on (:func:`compute_mesh`)."""
        return compute_mesh(self.mesh)

    def pspec(self, *logical: str | None) -> PartitionSpec | None:
        if self.mesh is None:
            return None
        return resolve(self.mesh, logical, None, self.overrides)

    def sharding(self, *logical: str | None) -> NamedSharding | None:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, resolve(self.mesh, logical, None,
                                                self.overrides))

    def placements_for(self, shape: Sequence[int], *logical: str | None
                       ) -> tuple:
        """Placements on :attr:`cmesh` of a ``shape`` tensor with
        ``logical`` axes (the axes that do not divide it replicated)."""
        return placements(self.cmesh, resolve(self.cmesh, logical, shape,
                                              self.overrides))

    def constrain(self, x: torch.Tensor, *logical: str | None
                  ) -> torch.Tensor:
        """``x`` redistributed to ``logical``'s placements.  A plain
        tensor on a mesh is taken as replicated (every rank holds it
        whole, as a plain tensor in model code on a mesh does)."""
        if self.mesh is None:
            return x
        if not is_device_mesh(self.mesh):
            raise TypeError("constrain needs a DeviceMesh; a MeshShape "
                            "gives shapes only")
        x = as_dtensor(x, self.cmesh)
        want = self.placements_for(x.shape, *logical)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.cmesh, want)

    def gather_weights(self, tree: Any) -> Any:
        """FSDP's all-gather: every DTensor leaf of ``tree`` whole over
        every mesh dim but ``model`` (its TP shards kept), on
        :attr:`cmesh`.  Model code gathers a unit's weights at the
        unit's entry, so remat's recompute gathers them again and the
        grads reduce-scatter back to the params' placements."""
        if not is_device_mesh(self.mesh):
            return tree
        from torch.distributed.tensor import Replicate, Shard
        cmesh = self.cmesh

        def one(t):
            if not is_dtensor(t):
                return t
            names = axis_names(t.device_mesh)
            want = tuple(Replicate() if isinstance(pl, Shard)
                         and names[j] != "model" else pl
                         for j, pl in enumerate(t.placements))
            if want != tuple(t.placements):
                t = t.redistribute(t.device_mesh, want)
            if t.device_mesh is not cmesh:     # a re-view of the same block
                t = from_local(t.to_local(), cmesh,
                               (Replicate(), want[names.index("model")]))
            return t

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(walk(v) for v in t)
            return one(t) if torch.is_tensor(t) else t
        return walk(tree)

    def place(self, x: torch.Tensor, *logical: str | None):
        """A tensor that every rank holds whole (a batch, a param from
        numpy) as a DTensor keeping this rank's block; the identity
        without a mesh."""
        if self.mesh is None or is_dtensor(x):
            return x if self.mesh is None else self.constrain(x, *logical)
        return distribute(x, self.cmesh, self.placements_for(x.shape,
                                                             *logical))


def dp_size(mesh) -> int:
    n = axis_size(mesh, "data")
    if "pod" in axis_names(mesh):
        n *= axis_size(mesh, "pod")
    return n
