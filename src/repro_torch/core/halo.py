"""Distributed stencils on ``torch.distributed``: a deep halo exchange
over a ``DeviceMesh``, then the fused block on each shard.

The port's counterpart of ``repro.core.halo``, the paper's data mapping
at device scale: each rank owns a contiguous block of the grid (a stencil
segment's block on an LLC slice, §4.2), computes it locally, and trades
only the halo surface with its neighbours.  Temporal blocking extends the
trade across ranks: ``sweeps=t`` exchanges one ``t*halo``-deep halo per
``t`` sweeps, then runs all ``t`` applications on the widened block.
Where a neighbour's block is narrower than the deep halo, the exchange
gathers from ranks up to ``ceil(halo/size)`` hops away.

Each rank runs the same program on its own shard, in PyTorch's idiom:

* a mesh dim named ``name`` of a ``DeviceMesh`` takes the place of a JAX
  mesh axis: ``mesh.get_local_rank(name)`` of ``lax.axis_index``,
  ``mesh.size(dim)`` of ``lax.psum(1, name)``;
* one ``dist.batch_isend_irecv`` over ``mesh.get_group(name)`` (global
  peer ranks, ``dist.get_global_rank``) carries every hop of one
  exchange, both directions: the reference's ``lax.ppermute`` pairs;
* the function :func:`distributed_stencil_fn` returns maps this rank's
  shard to this rank's shard, where the reference's ``shard_map`` maps a
  global array; :func:`shard_grid` cuts a rank's shard out of a global
  grid and :func:`gather_grid` all-gathers the global grid back;
  :func:`sharding_for` gives the DTensor placements of the layout.

The boundary mode decides each sharded axis's exchange strategy at
lowering time (``plan.exchange_strategy_for``):

* ``zero-fill``: a rank with no neighbour that far receives zeros, and
  nothing is sent past the mesh's edge;
* ``wrap-ring`` (periodic): every hop is a wrap-around ring
  ``(i, (i+j) mod n)``, so edge ranks receive the opposite edge of the
  grid; where ``n`` divides ``j`` a rank is its own peer, and the pair is
  a local copy (no backend sends to itself);
* ``edge-fixup`` (constant / reflect): the zero-filled exchange, then the
  out-of-grid ghosts are overwritten locally with the fill or the mirror
  of the block's own, already exchanged, data.

Unsharded dims are boundary-padded locally.  The window then goes to K2
(``kernels.engine.stencil_window_sweep``) or, for a fusable chain, K4
(``pipeline_window_sweep``) with the shard's global origin on every
sharded dim and the global grid shape, or to the oracle's masked window
core for ``backend="ref"``; between fused sweeps both restore the ghosts
that lie outside the *global* grid, so a shard's result equals the
single-device run's block bit for bit in f64.

Transport: a gloo group's point-to-point calls take CPU tensors, so with
a gloo group and a shard on a CUDA device the edge slices are copied to
pinned host buffers and the received halos back (the group's backend
decides, :func:`staged_through_host`).  An NCCL group (one card per
rank) sends the device slices themselves.  Every edge is made contiguous
before it is sent (a slice along dim >= 1 is not).
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from . import plan as _plan
from . import ref as _ref

#: Exchange counters since the last :func:`reset_exchange`: ``rounds``,
#: one per hop, per direction, per sharded axis — the counterpart of the
#: reference's collective-permute count, a self pair's local copy
#: included; ``self_copies``, the rounds that were local copies;
#: ``bytes_sent``, the bytes this rank sent; ``seconds``, the host's wall
#: time in the exchanges (host staging included).
EXCHANGE: dict = {"rounds": 0, "self_copies": 0, "bytes_sent": 0,
                  "seconds": 0.0}

#: Per fused step, while :func:`record_steps` is on: the window's wall
#: time (exchange, staging and local padding, synchronized), the rounds,
#: the step's wall time and CUDA events around the kernel launch.
_STEP_RECORDS: list | None = None


def reset_exchange() -> None:
    for k in EXCHANGE:
        EXCHANGE[k] = 0.0 if k == "seconds" else 0


def record_steps(on: bool = True) -> None:
    """Start (and clear) or stop the per-step records."""
    global _STEP_RECORDS
    _STEP_RECORDS = [] if on else None


def step_records() -> list[dict]:
    """The steps recorded since :func:`record_steps`, each with
    ``window_ms``, ``rounds``, ``step_ms`` and, on a CUDA shard, the
    kernel's device time ``kernel_ms`` (CUDA events)."""
    out = []
    for rec in _STEP_RECORDS or ():
        rec = dict(rec)
        events = rec.pop("events", None)
        if events is not None:
            rec["kernel_ms"] = events[0].elapsed_time(events[1])
        out.append(rec)
    return out


def staged_through_host(group, x: torch.Tensor) -> bool:
    """Whether ``x``'s slices travel through pinned host buffers: a gloo
    group and a tensor off the CPU."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _dim_of(mesh, name: str) -> int:
    return list(mesh.mesh_dim_names).index(name)


def _post(ops: list, edge: torch.Tensor, to: int | None, src: int | None,
          me: int, group, host: bool, tag: int):
    """Queue one round (``edge`` to group rank ``to``; a slice of the same
    shape from group rank ``src``) on ``ops`` and return what the round
    delivers: zeros when there is no source, ``edge`` itself when this
    rank is its own peer, else ``(buffer, device)`` to read after the
    batch completes."""
    EXCHANGE["rounds"] += 1
    if src == me:                               # a self pair: a local copy
        EXCHANGE["self_copies"] += 1
        return edge
    if to is not None:
        buf = edge.contiguous()
        if host:
            pinned = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            pinned.copy_(buf)
            buf = pinned
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, to), group, tag))
        EXCHANGE["bytes_sent"] += buf.numel() * buf.element_size()
    if src is None:
        return torch.zeros_like(edge)
    buf = torch.empty(edge.shape, dtype=edge.dtype,
                      device="cpu" if host else edge.device, pin_memory=host)
    ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src),
                          group, tag))
    return (buf, edge.device)


def exchange_halo_1axis(x: torch.Tensor, axis: int, halo: int, mesh,
                        axis_name: str, *, mode: str = "zero",
                        value: float = 0.0,
                        strategy: str | None = None) -> torch.Tensor:
    """Pad dim ``axis`` of this rank's block ``x`` with ``halo`` elements
    of its neighbours along mesh dim ``axis_name`` per side, serving the
    grid's edges per the exchange ``strategy``.

    This block's right edge goes to the right neighbour (it becomes that
    neighbour's left halo) and its left edge to the left one.  ``halo``
    may exceed the block: the exchange then gathers from ranks up to
    ``ceil(halo/size)`` hops away, the farthest piece
    ``min(size, halo - (j-1)*size)`` wide; the left halo is joined
    farthest first, the right halo nearest first.  All hops and both
    directions go in one ``batch_isend_irecv``.

    ``strategy`` is one of :data:`repro_torch.core.plan.EXCHANGE_STRATEGIES`;
    ``None`` resolves it from ``mode``
    (:func:`repro_torch.core.plan.exchange_strategy_for`).
    ``mode``/``value`` parameterize the edge fix-up (fill or mirror).
    Every rank of the mesh dim's group must call it together."""
    if halo == 0:
        return x
    if strategy is None:
        strategy = _plan.exchange_strategy_for(mode)
    if strategy not in _plan.EXCHANGE_STRATEGIES:
        raise ValueError(f"unknown exchange strategy {strategy!r}")
    t0 = time.perf_counter()
    n = mesh.size(_dim_of(mesh, axis_name))
    me = mesh.get_local_rank(axis_name)
    group = mesh.get_group(axis_name)
    host = staged_through_host(group, x)
    size = x.shape[axis]
    hops = -(-halo // size)
    ops: list = []
    from_left, from_right = [], []
    for j in range(1, hops + 1):
        w = min(size, halo - (j - 1) * size)
        right_edge = x.narrow(axis, size - w, w)
        left_edge = x.narrow(axis, 0, w)
        if strategy == "wrap-ring":
            right, left = (me + j) % n, (me - j) % n
        elif j >= n:                    # no rank that far: the grid's edge
            from_left.append(torch.zeros_like(right_edge))
            from_right.append(torch.zeros_like(left_edge))
            continue
        else:
            right = me + j if me + j < n else None
            left = me - j if me - j >= 0 else None
        # right edges travel right (the receiver's left halo), left edges
        # left; each pair posts in this order, so NCCL matches it too
        from_left.append(_post(ops, right_edge, right, left, me, group,
                               host, 2 * j))
        from_right.append(_post(ops, left_edge, left, right, me, group,
                                host, 2 * j + 1))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def arrived(piece):
        if isinstance(piece, tuple):
            buf, device = piece
            return buf.to(device, non_blocking=True)
        return piece
    out = torch.cat([arrived(p) for p in from_left[::-1]] + [x]
                    + [arrived(p) for p in from_right], dim=axis)
    if strategy == "edge-fixup":
        out = _fix_edge_ghosts_1axis(out, axis, halo, me * size, n * size,
                                     mode, value)
    EXCHANGE["seconds"] += time.perf_counter() - t0
    return out


def _fix_edge_ghosts_1axis(padded: torch.Tensor, axis: int, halo: int,
                           start: int, grid_n: int, mode: str,
                           value: float) -> torch.Tensor:
    """Overwrite the out-of-grid coordinates along ``axis`` of a block
    exchanged ``halo`` deep (its interior starts at global ``start`` of a
    ``grid_n``-point axis) with the ``constant`` fill or the ``reflect``
    mirror of the block's own, already exchanged, data."""
    ext = padded.shape[axis]
    if mode == "constant":
        g = start - halo + torch.arange(ext, device=padded.device)
        shape = [1] * padded.ndim
        shape[axis] = ext
        inside = ((g >= 0) & (g < grid_n)).reshape(shape)
        return torch.where(inside, padded,
                           torch.tensor(value, dtype=padded.dtype,
                                        device=padded.device))
    if mode != "reflect":
        raise ValueError(f"edge fix-up serves constant and reflect, not "
                         f"{mode!r}")
    return _ref.reflect_gather(padded, axis, start - halo, grid_n, ext)


def _window(plan, x: torch.Tensor):
    """This rank's block widened by ``plan.deep_halo``: exchanged on the
    sharded dims per the plan's strategies, boundary-padded on the
    others; and the block's global origin."""
    mode, value = plan.boundary_mode, plan.boundary_value
    padded = x
    origin = []
    for d, name in enumerate(plan.grid_axes):
        if name is not None:
            padded = exchange_halo_1axis(padded, d, plan.deep_halo[d],
                                         plan.mesh, name, mode=mode,
                                         value=value,
                                         strategy=plan.exchange[d])
            origin.append(plan.mesh.get_local_rank(name) * x.shape[d])
        else:
            pad = [0] * x.ndim
            pad[d] = plan.deep_halo[d]
            padded = _ref.pad_boundary(padded, pad, mode, value)
            origin.append(0)
    return padded, tuple(origin)


def _shard_block(plan, x: torch.Tensor, window: torch.Tensor,
                 origin) -> torch.Tensor:
    """``plan.sweeps`` applications on the exchanged window: K2 (a spec)
    or K4 (a fusable chain) for ``"cuda"``, the oracle's masked window
    core for ``"ref"``; the global grid shape places the ghosts."""
    spec = plan.spec
    if plan.backend in _plan.KERNEL_BACKENDS:
        from ..kernels import engine as _keng
        sweep = (_keng.pipeline_window_sweep if plan.is_pipeline
                 else _keng.stencil_window_sweep)
        return sweep(spec, window, x.shape, origin, plan.shape,
                     tile=plan.tile, sweeps=plan.sweeps)
    if plan.is_pipeline:
        return _ref.masked_window_pipeline(
            window, spec.stages, x.shape, plan.sweeps, origin, plan.shape,
            x.dtype).to(x.dtype)
    return _ref.masked_window_sweeps(
        window, spec.taps, plan.halo, x.shape, plan.sweeps, origin,
        plan.shape, x.dtype, mode=plan.boundary_mode,
        value=plan.boundary_value, structure=spec.structure).to(x.dtype)


def execute_plan(plan, x: torch.Tensor) -> torch.Tensor:
    """One fused distributed step of a lowered plan on this rank's shard
    ``x``: the deep halo exchange, then ``plan.sweeps`` shard-local
    applications.  Every rank of the plan's mesh must call it together."""
    if not plan.is_distributed:
        raise ValueError("plan has no mesh; use the single-device executors")
    if tuple(x.shape) != plan.shard_shape:
        raise ValueError(f"shard shape {tuple(x.shape)} != the plan's "
                         f"{plan.shard_shape}")
    records = _STEP_RECORDS
    if records is None:
        return _shard_block(plan, x, *_window(plan, x))
    cuda = x.device.type == "cuda"
    t0 = time.perf_counter()
    rounds = EXCHANGE["rounds"]
    window, origin = _window(plan, x)
    if cuda:
        torch.cuda.synchronize(x.device)
    t1 = time.perf_counter()
    events = None
    if cuda:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    out = _shard_block(plan, x, window, origin)
    if cuda:
        events[1].record()
        torch.cuda.synchronize(x.device)
    records.append({"window_ms": (t1 - t0) * 1e3,
                    "rounds": EXCHANGE["rounds"] - rounds,
                    "step_ms": (time.perf_counter() - t0) * 1e3,
                    "events": events})
    return out


def _global_shape(local_shape: Sequence[int], mesh,
                  grid_axes: Sequence[str | None]) -> tuple[int, ...]:
    """The global grid shape of shards of ``local_shape``."""
    return tuple(int(n) * _plan.mesh_axis_size(mesh, a)
                 for n, a in zip(local_shape, grid_axes))


def distributed_stencil_fn(spec, mesh, grid_axes: Sequence[str | None],
                           iters: int = 1, *, sweeps: int = 1,
                           backend: str = "ref", tile=None,
                           device=None) -> Callable:
    """A function that maps this rank's shard of the grid to this rank's
    shard after ``iters`` stencil applications on ``mesh`` (a
    ``DeviceMesh``; every rank of it calls the function together).

    ``grid_axes[d]`` names the mesh dim that shards grid dim ``d``
    (``None``: not sharded).  ``spec`` may be a fusable
    :class:`~repro_torch.core.stencil.StencilPipeline`, which exchanges
    one ``sweeps * sum(stage radii)``-deep halo per fused step and runs
    every stage application on the shard (K4), or a non-fusable one,
    whose stage plans run one distributed step per stage.  ``sweeps=t``
    takes one ``t*halo``-deep exchange per ``t`` applications; ``iters``
    decomposes as ``q*t + r`` (``plan.run_plan``): ``q`` fused steps and
    one narrower remainder step.  ``backend`` is ``"ref"`` (the oracle's
    window core) or ``"cuda"`` (K2/K4; on a CPU device their plain
    versions).  ``tile="auto"`` is tuned on the shard shape once per plan,
    on mesh rank 0, and broadcast.  The shard is moved to ``device``
    (``None``: ``"cuda"``, which raises where CUDA is missing); the
    mesh's process group only says who the ranks are."""
    if len(grid_axes) != spec.ndim:
        raise ValueError("grid_axes must have one entry per grid dim")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if backend not in ("ref",) + _plan.KERNEL_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    axes = tuple(grid_axes)
    from ..device import resolve_device
    dev = resolve_device(device)

    def run(local) -> torch.Tensor:
        local = torch.as_tensor(local)
        plan = _plan.lower(spec, _global_shape(local.shape, mesh, axes),
                           local.dtype, backend=backend, sweeps=sweeps,
                           tile=tile, device=dev, mesh=mesh, grid_axes=axes)
        return _plan.run_plan(plan, local.to(dev).contiguous(), iters)
    return run


def sharding_for(mesh, grid_axes: Sequence[str | None]) -> tuple:
    """The DTensor placements of a grid sharded by ``grid_axes``: per mesh
    dim, ``Shard(d)`` for the grid dim it shards, else ``Replicate()``
    (the reference's ``NamedSharding(mesh, P(*grid_axes))``)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(grid_axes) if a == name]
        if len(dims) > 1:
            raise ValueError(f"mesh dim {name!r} shards grid dims {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_grid(grid: torch.Tensor, mesh,
               grid_axes: Sequence[str | None]) -> torch.Tensor:
    """This rank's shard of the global ``grid`` (a contiguous copy)."""
    out = torch.as_tensor(grid)
    for d, name in enumerate(grid_axes):
        if name is None:
            continue
        n = _plan.mesh_axis_size(mesh, name)
        if out.shape[d] % n:
            raise ValueError(f"grid dim {d} ({out.shape[d]}) not divisible "
                             f"by mesh dim {name!r} ({n})")
        size = out.shape[d] // n
        out = out.narrow(d, mesh.get_local_rank(name) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather_grid(local: torch.Tensor, mesh,
                grid_axes: Sequence[str | None]) -> torch.Tensor:
    """The global grid, all-gathered from every rank's shard ``local``
    (one all-gather per sharded dim, through host memory on a gloo group
    as the exchange), on ``local``'s device."""
    out = local
    for d, name in enumerate(grid_axes):
        if name is None:
            continue
        group = mesh.get_group(name)
        host = staged_through_host(group, out)
        src = out.cpu() if host else out.contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=d).to(local.device)
    return out
