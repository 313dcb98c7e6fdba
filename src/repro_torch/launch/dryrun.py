"""The dry run: every (arch x shape cell x mesh) and every paper stencil
lowered on the production meshes, with no devices.

    python -m repro_torch.launch.dryrun [--arch ID|all|stencils]
        [--cell NAME|all] [--mesh pod|multipod|both] [--variant NAME]
        [--out FILE] [--force] [--full-depth] [--jobs N]

:func:`lower_cell` is the reference's ``lower_cell`` in PyTorch's idiom.
The reference lowers and compiles a cell on 256 or 512 forced XLA host
devices and walks the partitioned HLO; here one process joins a *fake*
process group of 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks
(``torch.testing._internal.distributed.fake_pg``: no communication, no
other process), builds the production ``DeviceMesh`` on it
(``launch/mesh.py`` ``build``, device type ``cpu``), makes fake local
shards of the params, optimizer state, decode state and batch (the
shard shapes :func:`~repro_torch.models.common.abstract_params` gives,
rank 0's block), and traces the cell's step through the port's own entry
points with ``make_fx(..., tracing_mode="fake")``: ``make_train_step``
(AdamW with 8-bit state for ``QUANTIZE_OPT``), the arch's ``prefill``
and ``decode``, each under ``ShardCtx`` on ``compute_mesh`` as the
sharded paths run.  The graph holds rank 0's local ops and DTensor's
collectives; :func:`~repro_torch.roofline.graph_walk.walk` reads its
per-device FLOPs, bytes, collectives and memory split and
:func:`~repro_torch.roofline.analysis.build_roofline` prices them at the
H100's data-sheet rates (model seconds, not measurements).

Depth: a transformer is traced at one and at two units of its layer
pattern, zamba2 at three and five of its units (the shared block fires
on the odd ones, once per two units), and the totals are carried
linearly to the full depth (``Totals.extended``), as the reference's
walk multiplies a scanned body by its trip count.  xLSTM, which steps
its sLSTM one token at a time in Python, is traced at every layer on
three sequence lengths and carried to a long cell's along a quadratic
(``seq_plan``); Whisper is traced whole.  ``full_depth=True`` traces every layer and every
position.  While tracing, DTensor's sharding propagation and
redistribution planning run outside the fake and proxy modes and are
memoised (:func:`traceable_dtensor`): under ``make_fx``
DTensor skips its own caches and plans every op anew, with index
tensors that the proxy mode records element by element.

:func:`lower_stencil` counts a paper stencil at the reference's
``STENCIL_DOMAINS`` on ``stencil_mesh_shape``.  The port's K2/K4 are
``ctypes`` calls a fake tensor cannot enter and its exchange is
``batch_isend_irecv``, which ``make_fx`` does not record, so the record
counts from the plan ``core/halo.py`` ``distributed_stencil_fn`` lowers
(on a ``MeshShape``, no ranks): FLOPs from the contract's operations per
point times the shard's points times ``iters``, bytes from
``kernels/engine.py`` ``hbm_traffic`` on the shard's window, and the
exchange's rounds and bytes per rank from ``analysis/launch_lint.py``
``predicted_exchange``.

:func:`cell_record` keeps the shardings' own count (a record's
``resident_bytes``): the resident bytes the shardings imply, before any
temporaries.  The
per-cell config knobs (``CELL_OVERRIDES``, ``QUANTIZE_OPT``,
``DEPLOY_ACCUM``, ``_cfg_for``, ``_deploy``, ``VARIANTS``) are the
reference's (``src/repro/launch/dryrun.py``).  :func:`main` is
resumable: records already ``ok`` or ``skipped`` in ``--out`` are kept
unless ``--force``; it exits 1 on any ``error``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, get_config
from ..models import CELLS, cell_supported, input_specs, make_arch
from ..models.common import (abstract_params, is_pspec, leaf_placements,
                             tree_leaves, tree_map)
from ..models.registry import ShapeCell, family_impl
from ..optim import AdamWConfig, opt_state_specs
from ..roofline import graph_walk
from ..roofline.analysis import (HARDWARE, RANKS_PER_NODE, bottleneck_of,
                                 build_roofline, roofline_terms)
from ..sharding import MeshShape, ShardCtx, from_local, is_dtensor
from .mesh import build, production_mesh_shape, stencil_mesh_shape

RESULTS_DEFAULT = "build/dryrun_torch.json"

# Per-cell baseline implementation knobs (the reference's).
CELL_OVERRIDES = {
    "prefill_32k": dict(block_q=2048, block_k=2048, attn_impl="blockwise"),
    "decode_32k": dict(block_k=4096, attn_impl="blockwise"),
    "long_500k": dict(block_k=16384, attn_impl="blockwise"),
    "train_4k": dict(block_q=1024, block_k=1024, attn_impl="blockwise"),
}

# archs whose optimizer state only fits with 8-bit moments
QUANTIZE_OPT = {"nemotron-4-340b", "internvl2-76b"}


def _moe_local(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="local"))


def _expert_pad(cfg):
    # pad the expert dim up to a multiple of the 16-way EP axis
    e = cfg.moe.n_experts
    pad = -(-e // 16) * 16
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, pad_experts_to=pad))


# microbatch (grad-accumulation) factors of the reference's deploy sweep
DEPLOY_ACCUM = {
    "nemotron-4-340b": 8, "qwen3-14b": 8, "olmoe-1b-7b": 4, "internvl2-76b": 8,
    "qwen2-moe-a2.7b": 4, "zamba2-7b": 4,
    "gemma2-27b": 4, "whisper-tiny": 4, "yi-9b": 2, "xlstm-125m": 8,
}


def _deploy(cfg):
    # flash-decode where head sharding would replicate the cache (n_kv
    # not divisible by the 16-way TP group); the reference's deploy knobs
    seq_shard_kv = cfg.n_kv % 16 != 0
    cfg = dataclasses.replace(
        cfg, decode_kv_seq_shard=seq_shard_kv, fuse_qkv=True,
        accum_steps=DEPLOY_ACCUM.get(cfg.arch, 1))
    if cfg.moe is not None:
        cfg = _moe_local(cfg)
        if cfg.moe.n_experts % 16 != 0:
            cfg = _expert_pad(cfg)
    return cfg


VARIANTS = {
    "baseline": lambda cfg: cfg,
    "flashdecode": lambda cfg: dataclasses.replace(
        cfg, decode_kv_seq_shard=True),
    "moelocal": _moe_local,
    "qkvfused": lambda cfg: dataclasses.replace(cfg, fuse_qkv=True),
    "noseqshard": lambda cfg: dataclasses.replace(cfg, seq_shard=False),
    "blockq4k": lambda cfg: dataclasses.replace(cfg, block_q=4096,
                                                block_k=4096),
    "accum8": lambda cfg: dataclasses.replace(cfg, accum_steps=8),
    "expertpad": lambda cfg: _expert_pad(_deploy(cfg)),
    "deploy": _deploy,
}


def _cfg_for(arch_id: str, cell_name: str, shrink=None):
    cfg = get_config(arch_id)
    if shrink is not None:             # tests: a reduced config
        cfg = shrink(cfg)
    over = dict(CELL_OVERRIDES.get(cell_name, {}))
    cell = CELLS[cell_name]
    if cfg.family == "audio" and cell.kind != "train":
        # decoder positions must cover the cell
        over["max_seq"] = max(cfg.max_seq, cell.seq_len + 64)
    if cfg.moe is not None:
        # dispatch groups track the DP degree
        over["moe"] = dataclasses.replace(
            cfg.moe, n_groups=min(32, cell.global_batch))
    return dataclasses.replace(cfg, **over)


def _max_len(cell) -> int:
    return cell.seq_len + 16     # decode room; divisible by 16


def _bytes(tree) -> int:
    """Bytes one device holds of ``tree`` (its largest shard per leaf)."""
    return sum(a.shard_bytes for a in tree_leaves(
        tree, lambda x: hasattr(x, "shard_bytes")))


def abstract_cell(arch_id: str, cell_name: str, mesh, variant="baseline",
                  shrink=None):
    """The cell's config and its abstract trees on ``mesh`` (a
    ``MeshShape``): ``params``, and ``opt`` (train), ``state`` (decode)
    and ``batch``; ``None`` where the cell is skipped."""
    cell = CELLS[cell_name]
    cfg = VARIANTS[variant](_cfg_for(arch_id, cell_name, shrink))
    if not cell_supported(cfg, cell)[0]:
        return cfg, None
    arch = make_arch(cfg)
    overrides = ({"fsdp": None}
                 if cfg.serve_params_tp_only and cell.kind != "train"
                 else None)
    specs = arch.param_specs(cfg)
    trees = {"params": abstract_params(specs, mesh, overrides),
             "batch": input_specs(cfg, cell, mesh)}
    if cell.kind == "train":
        opt_cfg = AdamWConfig(quantize_state=arch_id in QUANTIZE_OPT)
        trees["opt"] = abstract_params(opt_state_specs(specs, opt_cfg), mesh)
    elif cell.kind == "decode":
        trees["state"] = abstract_params(
            arch.decode_state_specs(cfg, cell.global_batch, _max_len(cell)),
            mesh)
    return cfg, trees


def _mesh_name(multi_pod: bool, variant: str = "baseline") -> str:
    name = "pod2x16x16" if multi_pod else "pod16x16"
    return name if variant == "baseline" else f"{name}+{variant}"


def cell_record(arch_id: str, cell_name: str, multi_pod: bool,
                variant: str = "baseline", shrink=None) -> dict:
    mesh = production_mesh_shape(multi_pod=multi_pod)
    rec = {"kind": "lm", "arch": arch_id, "cell": cell_name,
           "mesh": _mesh_name(multi_pod, variant), "devices": mesh.size}
    cfg, trees = abstract_cell(arch_id, cell_name, mesh, variant, shrink)
    if trees is None:
        return {**rec, "status": "skipped",
                "reason": cell_supported(cfg, CELLS[cell_name])[1]}
    per = {k: _bytes(t) for k, t in trees.items()}
    return {**rec, "status": "ok",
            "bytes_per_device": {**per, "total": sum(per.values())},
            "params_total": sum(math.prod(a.shape) * a.dtype.itemsize
                                for a in tree_leaves(
                                    trees["params"],
                                    lambda x: hasattr(x, "shard_bytes")))}


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------
_MESHES: dict = {}          # MeshShape -> its DeviceMesh on the fake world
_PLANS: dict = {}           # traceable_dtensor's memo for this world


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake process group of ``n`` ranks,
    or keep the one it is in.  A fake group of another size is torn
    down first; a real one is left alone and refused."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake process group; "
                               f"this process is in a "
                               f"{dist.get_backend()!r} one")
        if dist.get_world_size() == n:
            return
        end_fake_world()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def end_fake_world() -> None:
    """Destroy this process's fake process group and its meshes."""
    import torch.distributed as dist
    _MESHES.clear()
    _PLANS.clear()
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
    # DTensor's own caches hold plans on the meshes of the world just
    # ended, which a new world's meshes hash equal to: a plan served from
    # them carries an old mesh, whose groups' names the new world has
    # given to other groups (a collective then reads another group's
    # size)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import _redistribute as rd
    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(prop.propagate_op_sharding, "cache_clear", None),
               getattr(getattr(type(prop), "_propagate_tensor_meta_cached",
                               None), "cache_clear", None),
               getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                       None),
               getattr(getattr(getattr(cu, "MeshTopoInfo", None),
                               "build_from_mesh", None), "cache_clear",
                       None),
               getattr(getattr(rd, "_gen_transform_infos", None),
                       "cache_clear", None),
               getattr(rd, "clear_redistribute_planner_cache", None)):
        if fn is not None:
            fn()


def fake_mesh(shape: MeshShape):
    """The ``DeviceMesh`` of ``shape`` on a fake world of its size."""
    from ..sharding import _ROUTED
    fake_world(shape.size)
    if "cpu" in _ROUTED:
        raise RuntimeError("CPU all-gathers are routed through "
                           "dist.all_gather_into_tensor (route_gloo_gathers);"
                           " a traced graph would not show them")
    if shape not in _MESHES:
        _MESHES[shape] = build(shape, "cpu")
    return _MESHES[shape]


@contextlib.contextmanager
def traceable_dtensor():
    """DTensor under ``make_fx`` at the speed it runs eagerly.

    While it traces, DTensor plans every op's sharding and every
    redistribution anew (its caches are skipped when it sees a fake or
    proxy mode), and the plans compute index tensors that the proxy mode
    records and ``tolist()`` turns into an unbacked symbol per element.
    Here the sharding propagator, the redistribution planner and
    ``_StridedShard``'s shard-size rule (where the installed torch has
    them) run outside both modes, on the metadata they are given, and
    are memoised for the scope (the same op on the same specs has the
    same plan; the memo lives as long as the fake world and its meshes).
    A shard-to-shard move takes the all-to-all a CUDA mesh runs, where
    DTensor on a CPU mesh falls back to an all-gather and a chunk.
    The graph is unchanged: those plans compute no tensor the step
    uses."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute as rd
    from torch.distributed.tensor import placement_types as pt
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing
    memo = _PLANS

    def plain(key, fn):
        if key not in memo:
            with unset_fake_temporarily(), disable_proxy_modes_tracing():
                memo[key] = fn()
        out = memo[key]
        return (out[0], list(out[1])) if (
            key[0] == "s" and isinstance(out, tuple)
            and isinstance(out[1], list)) else out

    undo = []
    prop = DTensor._op_dispatcher.sharding_propagator
    p_orig = getattr(prop, "propagate_op_sharding_non_cached", None)
    if p_orig is not None:
        prop.propagate_op_sharding_non_cached = (
            lambda schema: plain(("p", schema), lambda: p_orig(schema)))
        undo.append(lambda: delattr(prop,
                                    "propagate_op_sharding_non_cached"))
    r_orig = getattr(rd, "_gen_transform_infos_non_cached", None)
    if r_orig is not None:
        def infos(src, dst, *a, **k):
            return plain(("r", src, dst, a, tuple(sorted(k.items()))),
                         lambda: r_orig(src, dst, *a, **k))
        rd._gen_transform_infos_non_cached = infos
        undo.append(lambda: setattr(rd, "_gen_transform_infos_non_cached",
                                    r_orig))
    strided = getattr(pt, "_StridedShard", None)
    s_orig = strided.__dict__.get("local_shard_size_and_offset") \
        if strided is not None else None
    if callable(s_orig):
        def sizes(self, *a, **k):
            return plain(("s", self, a, tuple(sorted(k.items()))),
                         lambda: s_orig(self, *a, **k))
        strided.local_shard_size_and_offset = sizes
        undo.append(lambda: setattr(strided, "local_shard_size_and_offset",
                                    s_orig))
    a2a = getattr(pt, "shard_dim_alltoall", None)
    if a2a is not None and hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
        pt.shard_dim_alltoall = alltoall
        undo.append(lambda: setattr(pt, "shard_dim_alltoall", a2a))
    try:
        yield
    finally:
        for fn in reversed(undo):
            fn()


# ---------------------------------------------------------------------------
# Tracing a cell's step
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One input leaf: its global shape and dtype and, on a mesh, its
    placements (rank 0's block is the local shard)."""

    shape: tuple
    dtype: torch.dtype
    mesh: object = None
    places: tuple | None = None

    @property
    def local_shape(self) -> tuple:
        from torch.distributed.tensor import Shard
        out = list(self.shape)
        for j, pl in enumerate(self.places or ()):
            if isinstance(pl, Shard):
                out[pl.dim] = -(-out[pl.dim] // self.mesh.size(j))
        return tuple(out)


def _is_leaf(x) -> bool:
    return isinstance(x, _Leaf)


def _on(mesh, overrides=None):
    def one(s):
        if not s.shape:                 # the optimizer's step: plain
            return _Leaf((), s.dtype)
        return _Leaf(tuple(s.shape), s.dtype, mesh,
                     leaf_placements(mesh, s, overrides))
    return lambda tree: tree_map(one, tree, is_pspec)


def trace_sharded(fn, inputs: dict) -> torch.fx.GraphModule:
    """``make_fx`` (fake) of ``fn(**trees)``, where each tree of
    ``inputs`` holds :class:`_Leaf` s: the traced function takes every
    leaf's local shard (fake, in :func:`tree_leaves` order), wraps the
    mesh leaves with ``DTensor.from_local`` and returns the local part
    of every output tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    leaves = list(tree_leaves(inputs, _is_leaf))
    with FakeTensorMode():
        args = [torch.empty(lf.local_shape, dtype=lf.dtype)
                for lf in leaves]

    def run(*local):
        it = iter(local)

        def wrap(lf):
            t = next(it)
            if lf.mesh is None:
                return t
            return from_local(t, lf.mesh, lf.places, lf.shape)
        out = fn(**tree_map(wrap, inputs, _is_leaf))
        return [t.to_local() if is_dtensor(t) else t
                for t in tree_leaves(out, torch.is_tensor)
                if torch.is_tensor(t)]
    return graph_walk.trace(run, *args)


def trace_lm(cfg, kind: str, mesh, rows: int, seq: int, *,
             max_len: int | None = None, cache_len: int | None = None,
             opt_cfg=None, token_dtype=torch.int32):
    """The graph of one step of ``cfg`` on ``mesh`` (a ``DeviceMesh``):
    ``kind`` ``"train"`` (``make_train_step`` with ``opt_cfg``),
    ``"prefill"`` (``rows x seq`` prompt tokens, caches of ``max_len``)
    or ``"decode"`` (one token per row on caches of ``max_len`` holding
    ``cache_len``).  Serving params are TP-only where
    ``cfg.serve_params_tp_only``."""
    arch = make_arch(cfg)
    overrides = ({"fsdp": None}
                 if cfg.serve_params_tp_only and kind != "train" else None)
    ctx = ShardCtx(mesh, overrides=overrides)
    cmesh = ctx.cmesh
    specs = arch.param_specs(cfg)
    cell = ShapeCell(kind, seq, rows, kind)
    batch = {k: _Leaf(a.shape, token_dtype if k == "tokens" else a.dtype,
                      cmesh, a.placements)
             for k, a in input_specs(cfg, cell, cmesh).items()}
    inputs = {"params": _on(mesh, overrides)(specs), "batch": batch}
    if kind == "train":
        from ..train.loop import make_train_step
        inputs["opt"] = _on(mesh)(opt_state_specs(specs, opt_cfg))
        step = make_train_step(arch, opt_cfg, ctx)

        def fn(params, opt, batch):
            return step(params, opt, batch)
    elif kind == "prefill":
        def fn(params, batch):
            return arch.prefill(params, batch, cfg, ctx, max_len=max_len)
    else:
        inputs["state"] = _on(cmesh)(arch.decode_state_specs(
            cfg, rows, max_len))

        def fn(params, state, batch):
            return arch.decode(params, state, cache_len, batch["tokens"],
                               cfg, ctx)
    return trace_sharded(fn, inputs)


def _trace_cell(arch_id: str, cfg, cell, mesh):
    """The graph of ``cell``'s step of ``cfg`` on ``mesh``."""
    return trace_lm(
        cfg, cell.kind, mesh, cell.global_batch, cell.seq_len,
        max_len=_max_len(cell), cache_len=cell.seq_len,
        opt_cfg=AdamWConfig(quantize_state=arch_id in QUANTIZE_OPT))


def depth_plan(cfg) -> tuple[int, int, int] | None:
    """(depth, depth + period, repeats) that carry two traces to
    ``cfg.n_layers = depth + repeats * period``; ``None``: trace every
    layer.  A transformer repeats its layer pattern; zamba2 repeats two
    units of three blocks (the shared block fires on the odd units) after
    its first three units, whose one firing every trace needs (a unit
    that never fires leaves the shared weights without a gradient)."""
    fam = family_impl(cfg)
    if fam == "transformer":
        base = period = cfg.unit
    elif fam == "zamba":                # units 0-2, then (odd, even)
        base, period = 9, 6
    else:
        return None
    extra = cfg.n_layers - base
    if extra <= period or extra % period:
        return None
    return base, base + period, extra // period


SEQ_EXTEND_MIN = 12        # seq_plan: a cell of at least 12 base lengths


def seq_plan(cfg, cell, mesh: MeshShape) -> tuple[int, int] | None:
    """(seq, k): three traces of an xLSTM prefill or training cell at
    ``seq``, ``2 seq`` and ``3 seq`` carried to ``cell.seq_len = k seq``;
    ``None``: trace every position.  xLSTM steps its sLSTM one token at
    a time in Python (the reference scans it), so a trace grows with the
    sequence in nodes as well as in work; a step's FLOPs, bytes and peak
    are linear in the sequence (the per-step inputs come from one
    ``unbind``), and a quadratic through three traces carries them
    exactly.  ``seq`` is the least length that holds two or more whole
    mLSTM chunks and gives each rank of the "model" axis, which splits
    the residual stream's sequence, two or more positions (a trace of one
    chunk, or of one position a rank, takes other paths, and its peak
    falls elsewhere); the traces are used only where they cover a
    sixth of the cell or less."""
    if family_impl(cfg) != "xlstm" or cell.kind == "decode":
        return None
    base = math.lcm(2 * (cfg.ssm.chunk if cfg.ssm else 64),
                    2 * mesh.shape["model"])
    if cell.seq_len % base or cell.seq_len < SEQ_EXTEND_MIN * base:
        return None
    return base, cell.seq_len // base


def lower_cell(arch_id: str, cell_name: str, multi_pod: bool,
               variant: str = "baseline", *, full_depth: bool = False,
               shrink=None, cell=None) -> dict:
    """Trace one (arch x cell x mesh) on a fake world and walk it;
    returns the record (the reference's keys, ``trace_s``/``walk_s`` for
    its ``xla_raw_*``, and ``resident_bytes``: :func:`cell_record`'s).
    ``shrink`` (a config -> config map) and ``cell`` (a ``ShapeCell`` in
    place of ``CELLS[cell_name]``) size a cell down for tests."""
    shape = production_mesh_shape(multi_pod=multi_pod)
    mesh_name = _mesh_name(multi_pod, variant)
    cell = CELLS[cell_name] if cell is None else cell
    cfg = VARIANTS[variant](_cfg_for(arch_id, cell_name, shrink))
    ok, why = cell_supported(cfg, cell)
    if not ok:
        return {"kind": "lm", "arch": arch_id, "cell": cell_name,
                "mesh": mesh_name, "status": "skipped", "reason": why}
    mesh = fake_mesh(shape)
    dplan = None if full_depth else depth_plan(cfg)
    splan = None if full_depth or dplan else seq_plan(cfg, cell, shape)
    if dplan:
        steps = [(dataclasses.replace(cfg, n_layers=d), cell)
                 for d in dplan[:2]]
    elif splan:
        steps = [(cfg, dataclasses.replace(cell, seq_len=n * splan[0]))
                 for n in (1, 2, 3)]
    else:
        steps = [(cfg, cell)]
    t0 = time.perf_counter()
    graphs = []
    with traceable_dtensor():
        for c, k in steps:
            graphs.append(_trace_cell(arch_id, c, k, mesh))
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    totals = [graph_walk.walk(g, shape.size)
              for g in graphs]
    nodes = [len(g.graph.nodes) for g in graphs]
    del graphs
    if dplan:
        tot = totals[0].extended(totals[1], dplan[2])
    elif splan:
        k = splan[1]                    # Lagrange weights at 1, 2, 3
        tot = graph_walk.Totals()
        for t, w in zip(totals, ((k - 2) * (k - 3) / 2, -(k - 1) * (k - 3),
                                 (k - 1) * (k - 2) / 2)):
            tot.add(t, w)
    else:
        tot = totals[0]
    walk_s = time.perf_counter() - t0
    rl = build_roofline(arch_id, cell, mesh_name, shape.size, tot,
                        tot.memory, cfg)
    resident = (cell_record(arch_id, cell_name, multi_pod, variant,
                            shrink)["bytes_per_device"]
                if cell is CELLS.get(cell_name) else None)
    return {"kind": "lm", "status": "ok", "trace_s": trace_s,
            "walk_s": walk_s,
            "traced_depths": [c.n_layers for c, _ in steps],
            "traced_seq_lens": [k.seq_len for _, k in steps],
            "repeats": dplan[2] if dplan else 1,
            "graph_nodes": nodes, "resident_bytes": resident,
            "fits_hbm": tot.memory["peak_bytes"] <= HARDWARE["H100"][
                "hbm_bytes"], **rl.summary()}


# ---------------------------------------------------------------------------
# Stencils
# ---------------------------------------------------------------------------
STENCIL_DOMAINS = {1: (1 << 26,), 2: (8192, 8192), 3: (512, 512, 256)}


def stencil_axes(mesh: MeshShape, ndim: int) -> tuple:
    """Grid dim -> mesh dim, as the reference's dry run assigns them."""
    axes = list(mesh.axis_names) + [None] * (ndim - len(mesh.axis_names))
    return tuple(axes[:ndim])


def _global_rank(mesh: MeshShape, coord: dict) -> int:
    r = 0
    for name, n in zip(mesh.axis_names, mesh.shape_tuple):
        r = r * n + coord.get(name, 0)
    return r


def stencil_counts(spec, shape, mesh: MeshShape, grid_axes, iters: int, *,
                   sweeps: int = 1, dtype=torch.float32) -> dict:
    """Per-device counts of ``iters`` applications of ``spec`` on a
    ``shape`` grid sharded over ``mesh`` by ``grid_axes``, read off the
    plan ``distributed_stencil_fn`` lowers (``backend="cuda"``): FLOPs,
    HBM bytes (``hbm_traffic`` on the shard), and per rank the exchange's
    rounds and bytes sent, with the bytes that cross a node."""
    import itertools
    from ..analysis.launch_lint import predicted_exchange
    from ..core import plan as _plan
    from ..kernels.engine import hbm_pipeline_traffic, hbm_traffic
    plan = _plan.lower(spec, shape, dtype, backend="cuda", sweeps=sweeps,
                       device="cpu", mesh=mesh, grid_axes=tuple(grid_axes))
    itemsize = torch.empty((), dtype=dtype).element_size()
    q, r = plan.decompose(iters)
    steps = [(plan, q)] + ([(plan.remainder(r), 1)] if r else [])

    def traffic(p):
        if p.is_pipeline and p.fused:
            return hbm_pipeline_traffic(p.spec, p.shard_shape, p.tile,
                                        p.sweeps, itemsize)["fused_bytes"]
        if p.is_pipeline:
            return p.sweeps * sum(traffic(p.stage_plan(k))
                                  for k in range(len(p.stages)))
        return hbm_traffic(p.spec, p.shard_shape, p.tile, p.sweeps,
                           itemsize)["fused_bytes"]
    points = math.prod(plan.shard_shape)
    named = [a for a in plan.grid_axes if a is not None]
    per_rank = []
    for idx in itertools.product(*(range(mesh.shape[a]) for a in named)):
        coord = dict(zip(named, idx))
        me, sends = _global_rank(mesh, coord), []
        ex = predicted_exchange(plan, iters, coord, sends)
        # one step's sends (the remainder's after), weighted as
        # predicted_exchange counts them; bytes that leave the node
        per_step = sum(b for _, _, b in sends) or 1
        cross = sum(b for a, to, b in sends
                    if _global_rank(mesh, {**coord, a: to}) // RANKS_PER_NODE
                    != me // RANKS_PER_NODE)
        per_rank.append({"rank": me, **ex, "cross_node_bytes":
                         ex["bytes_sent"] * cross / per_step})
    return {"plan": plan, "flops": float(
                spec.structured_flops_per_point() * points * iters),
            "bytes": float(sum(traffic(p) * n for p, n in steps)),
            "shard_bytes": points * itemsize, "per_rank": per_rank}


def _stencil_key(name: str, multi_pod: bool) -> tuple:
    """(the stencil mesh, a record's key fields) of one paper stencil."""
    from ..core import PAPER_STENCILS
    nd = PAPER_STENCILS[name].ndim
    mesh = stencil_mesh_shape(nd, multi_pod=multi_pod)
    return mesh, {"kind": "stencil", "arch": name,
                  "cell": "x".join(map(str, STENCIL_DOMAINS[nd])),
                  "mesh": (("stencil512" if multi_pod else "stencil256")
                           + f"_{'x'.join(map(str, mesh.shape_tuple))}")}


def lower_stencil(name: str, multi_pod: bool, *, iters: int = 2) -> dict:
    """One paper stencil's record at ``STENCIL_DOMAINS`` on the stencil
    mesh (the reference's ``lower_stencil``; counted from the plan, see
    the module docstring).  FLOPs at the f32 rate outside the tensor
    cores (the kernel's), bytes at the HBM rate, the exchange's bytes
    (the most any rank sends; wire = operand, the reference's
    collective-permute) at the network rate where a hop crosses a node of
    eight, NVLink's otherwise."""
    from ..core import PAPER_STENCILS
    spec = PAPER_STENCILS[name]
    mesh, key = _stencil_key(name, multi_pod)
    shape = STENCIL_DOMAINS[spec.ndim]
    t0 = time.perf_counter()
    c = stencil_counts(spec, shape, mesh, stencil_axes(mesh, spec.ndim),
                       iters)
    plan_s = time.perf_counter() - t0
    worst = max(c["per_rank"], key=lambda x: (x["bytes_sent"],
                                              x["cross_node_bytes"]))
    sent = float(worst["bytes_sent"])
    by_link = {"network": worst["cross_node_bytes"],
               "nvlink": sent - worst["cross_node_bytes"]}
    h100 = HARDWARE["H100"]
    terms = roofline_terms(c["flops"], c["bytes"], by_link,
                           peak_flops=h100["f32"])
    plan = c["plan"]
    window = math.prod(n + 2 * h for n, h in zip(plan.shard_shape,
                                                 plan.deep_halo))
    itemsize = c["shard_bytes"] // math.prod(plan.shard_shape)
    memory = {"argument_size_in_bytes": float(c["shard_bytes"]),
              "output_size_in_bytes": float(c["shard_bytes"]),
              "alias_size_in_bytes": 0.0,
              "temp_size_in_bytes": float(window * itemsize),
              "peak_bytes": float(2 * c["shard_bytes"] + window * itemsize)}
    return {**key, "status": "ok", "plan_s": plan_s, "devices": mesh.size,
            "iters": iters, "shard": list(plan.shard_shape),
            "flops_per_device": c["flops"], "bytes_per_device": c["bytes"],
            "collective_bytes_per_device": sent,
            "t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
            "t_collective_s": terms["collective"],
            "t_collective_by_link_s": terms["by_link"],
            "bottleneck": bottleneck_of(terms), "memory": memory,
            "exchange_rounds": worst["rounds"],
            "exchange_bytes_by_rank": {
                "min": min(x["bytes_sent"] for x in c["per_rank"]),
                "max": sent, "rank0": c["per_rank"][0]["bytes_sent"]},
            "collective_ops": {"collective-permute": {
                "count": float(worst["rounds"]), "operand_bytes": sent,
                "wire_bytes": sent}}}


# ---------------------------------------------------------------------------
# Results and the CLI
# ---------------------------------------------------------------------------
def _key(r: dict) -> str:
    return f"{r['kind']}:{r['arch']}:{r['cell']}:{r['mesh']}"


def load_results(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return {_key(r): r for r in json.load(f)}
    return {}


def save_results(path: str, results: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(sorted(results.values(), key=_key), f, indent=1)


def _probe(job) -> dict:
    kind, a, cname, mp, variant, _ = job
    if kind == "stencil":
        return _stencil_key(a, mp)[1]
    return {"kind": "lm", "arch": a, "cell": cname,
            "mesh": _mesh_name(mp, variant)}


def run_job(job) -> dict:
    """One sweep job's record (``status: error`` with the exception on a
    failure); a worker process of ``main --jobs`` runs it."""
    kind, a, cname, mp, variant, full = job
    try:
        return (lower_stencil(a, mp) if kind == "stencil" else
                lower_cell(a, cname, mp, variant, full_depth=full))
    except Exception as e:
        return {**_probe(job), "status": "error",
                "error": f"{type(e).__name__}: {e}"[:2000],
                "traceback": traceback.format_exc()[-4000:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'stencils'")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace every layer (no depth extension)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, each with a fake world")
    args = ap.parse_args(argv)
    from ..core import PAPER_STENCILS
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    archs = (ARCH_IDS if args.arch in ("all", "stencils") else [args.arch])
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    jobs = []
    if args.arch in ("all", "stencils"):
        jobs += [("stencil", n, None, mp, args.variant, False)
                 for n in PAPER_STENCILS for mp in meshes]
    if args.arch != "stencils":
        jobs += [("lm", a, c, mp, args.variant, args.full_depth)
                 for a in archs for c in cells for mp in meshes]
    results = load_results(args.out)
    jobs = [j for j in jobs if args.force or results.get(
        _key(_probe(j)), {}).get("status") not in ("ok", "skipped")]

    def done(job, rec):
        results[_key(rec)] = rec
        save_results(args.out, results)
        extra = ""
        if rec["status"] == "ok":
            extra = (f" bottleneck={rec['bottleneck']} "
                     f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB"
                     + (f" trace={rec['trace_s']:.1f}s"
                        if "trace_s" in rec else ""))
        elif rec["status"] == "error":
            print(rec.get("traceback", ""), flush=True)
        print(f"[dryrun] {job[0]}:{job[1]}:{job[2]}:"
              f"{'multipod' if job[3] else 'pod'} -> {rec['status']}{extra}",
              flush=True)
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing
        # the training cells first: the longest jobs start earliest
        jobs.sort(key=lambda j: j[2] != "train_4k")
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as ex:
            futs = {ex.submit(run_job, j): j for j in jobs}
            for f in cf.as_completed(futs):
                done(futs[f], f.result())
    else:
        try:
            for job in jobs:
                print(f"[dryrun] {job[0]}:{job[1]}:{job[2]} ...", flush=True)
                done(job, run_job(job))
        finally:
            end_fake_world()
    n = {s: sum(r["status"] == s for r in results.values())
         for s in ("ok", "skipped", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors")
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
