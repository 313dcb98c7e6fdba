"""The port's placement layer against the reference's, on meshes with no
devices.

The reference's ``resolve`` reads only a mesh's axis names and sizes, and
``NamedSharding(...).shard_shape`` works on a ``jax.sharding.AbstractMesh``;
the port's :func:`repro_torch.sharding.resolve` and ``shard_shape`` take a
:class:`~repro_torch.sharding.MeshShape`.  Every arch's param, optimizer
(float32 and 8-bit), decode-state and input specs resolve to the same
partition specs and shard shapes in both packages, on (1, 1), (2, 2),
(4, 1), (1, 4), (16, 16) and (2, 16, 16), with and without
``{"fsdp": None}``; the dry run's bytes per device
(``repro_torch.launch.dryrun``) equal the sums of the reference's
``abstract_params`` shard shapes on the production meshes.
"""
import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jget_config
from repro.models import CELLS as JCELLS
from repro.models import input_specs as jinput_specs
from repro.models import make_arch as jmake_arch
from repro.models.common import abstract_params as jabstract_params
from repro.models.common import is_pspec as jis_pspec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.moe import MoeCfg as JMoeCfg
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import opt_state_specs as jopt_state_specs
from repro.sharding import resolve as jresolve
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (build, production_mesh_shape,
                                     stencil_mesh_shape)
from repro_torch.models import CELLS, input_specs, make_arch
from repro_torch.models.common import abstract_params, is_pspec, tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoeCfg
from repro_torch.optim import AdamWConfig, opt_state_specs
from repro_torch.sharding import (MeshShape, P, ShardCtx, dp_size,
                                  placements, resolve, shard_shape)

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
OVERRIDES = (None, {"fsdp": None})


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), MeshShape(shape, names)


def _jleaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=jis_pspec)[0]


def _pairs(jspecs, specs):
    """(reference PSpec, port PSpec) by path, the two trees' paths and
    leaves equal in shape and logical axes."""
    jl = [(jax.tree_util.keystr(p), s) for p, s in _jleaves(jspecs)]
    tl = list(tree_leaves(specs, is_pspec))
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape), path
        assert tuple(j.logical) == tuple(t.logical), path
    return [(path, j, t) for (path, j), t in zip(jl, tl)]


def _assert_resolves_alike(pairs, mesh_name, overrides=None):
    jmesh, mesh = _meshes(mesh_name)
    for path, j, t in pairs:
        jp = jresolve(jmesh, j.logical, j.shape, overrides)
        tp = resolve(mesh, t.logical, t.shape, overrides)
        assert tuple(tp) == tuple(jp), (path, tp, jp)
        assert shard_shape(mesh, tp, t.shape) == tuple(
            NamedSharding(jmesh, jp).shard_shape(j.shape)), path
        # and without a shape (ShardCtx.pspec), as the reference's
        assert tuple(resolve(mesh, t.logical, None, overrides)) == tuple(
            jresolve(jmesh, j.logical, None, overrides)), path


def _both(arch_id):
    jcfg, cfg = jget_config(arch_id), get_config(arch_id)
    return jcfg, jmake_arch(jcfg), cfg, make_arch(cfg)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_specs_resolve_like_reference(arch_id, mesh):
    jcfg, jarch, cfg, arch = _both(arch_id)
    pairs = _pairs(jarch.param_specs(jcfg), arch.param_specs(cfg))
    for ov in OVERRIDES:
        _assert_resolves_alike(pairs, mesh, ov)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_opt_state_specs_resolve_like_reference(arch_id):
    jcfg, jarch, cfg, arch = _both(arch_id)
    for q in (False, True):
        pairs = _pairs(
            jopt_state_specs(jarch.param_specs(jcfg),
                             JAdamWConfig(quantize_state=q)),
            opt_state_specs(arch.param_specs(cfg),
                            AdamWConfig(quantize_state=q)))
        for mesh in MESHES:
            _assert_resolves_alike(pairs, mesh)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_decode_state_specs_resolve_like_reference(arch_id):
    jcfg0, _, cfg0, _ = _both(arch_id)
    for flash in (False, True):
        jcfg = dataclasses.replace(jcfg0, decode_kv_seq_shard=flash)
        cfg = dataclasses.replace(cfg0, decode_kv_seq_shard=flash)
        jarch, arch = jmake_arch(jcfg), make_arch(cfg)
        for batch, max_len in ((1, 64), (128, 48)):
            pairs = _pairs(jarch.decode_state_specs(jcfg, batch, max_len),
                           arch.decode_state_specs(cfg, batch, max_len))
            for mesh in MESHES:
                _assert_resolves_alike(pairs, mesh)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_input_specs_like_reference(arch_id):
    jcfg, _, cfg, _ = _both(arch_id)
    for name in CELLS:
        for mesh_name in MESHES:
            jmesh, mesh = _meshes(mesh_name)
            want = jinput_specs(jcfg, JCELLS[name], jmesh)
            got = input_specs(cfg, CELLS[name], mesh)
            assert set(got) == set(want)
            for k, w in want.items():
                g = got[k]
                assert tuple(g.shape) == tuple(w.shape), (name, k)
                assert g.dtype.itemsize == np.dtype(w.dtype).itemsize
                assert tuple(g.sharding.spec) == tuple(w.sharding.spec)
                assert g.shard_shape == tuple(
                    w.sharding.shard_shape(w.shape)), (name, k)


def _to_reference(cfg):
    """The reference's ``ModelConfig`` with ``cfg``'s fields."""
    from repro.models.config import SsmCfg as JSsmCfg
    f = {x.name: getattr(cfg, x.name) for x in dataclasses.fields(cfg)}
    if f["moe"] is not None:
        f["moe"] = JMoeCfg(**dataclasses.asdict(f["moe"]))
    if f["ssm"] is not None:
        f["ssm"] = JSsmCfg(**dataclasses.asdict(f["ssm"]))
    return JModelConfig(**f)


def _reference_bytes(jcfg, cell, jmesh, overrides, quantize):
    """The reference's bytes per device of the cell's params (and
    optimizer state or decode state) from its ``abstract_params``."""
    jarch = jmake_arch(jcfg)
    specs = jarch.param_specs(jcfg)

    def total(tree):
        return sum(int(np.prod(a.sharding.shard_shape(a.shape)))
                   * np.dtype(a.dtype).itemsize
                   for a in jax.tree.leaves(tree))
    out = {"params": total(jabstract_params(specs, jmesh, overrides))}
    if cell.kind == "train":
        out["opt"] = total(jabstract_params(
            jopt_state_specs(specs, JAdamWConfig(quantize_state=quantize)),
            jmesh))
    elif cell.kind == "decode":
        out["state"] = total(jabstract_params(jarch.decode_state_specs(
            jcfg, cell.global_batch, cell.seq_len + 16), jmesh))
    out["batch"] = total(jinput_specs(jcfg, cell, jmesh))
    return out


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_dryrun_bytes_match_reference_shard_shapes(arch_id):
    for multi_pod in (False, True):
        ms = production_mesh_shape(multi_pod=multi_pod)
        jmesh = AbstractMesh(ms.shape_tuple, ms.axis_names)
        for name, cell in CELLS.items():
            rec = dryrun.cell_record(arch_id, name, multi_pod)
            cfg = dryrun._cfg_for(arch_id, name)
            if rec["status"] == "skipped":
                assert name == "long_500k"
                assert not cfg.supports_long_context
                continue
            jcfg = _to_reference(cfg)
            want = _reference_bytes(jcfg, JCELLS[name], jmesh, None,
                                    arch_id in dryrun.QUANTIZE_OPT)
            got = rec["bytes_per_device"]
            assert got == {**want, "total": sum(want.values())}, (name,
                                                                 multi_pod)


def _reference_constants():
    """CELL_OVERRIDES, QUANTIZE_OPT and DEPLOY_ACCUM of the reference's
    dry run, read from its source (importing it forces 512 host devices
    into XLA_FLAGS)."""
    path = os.path.join(os.path.dirname(HERE), "src", "repro", "launch",
                        "dryrun.py")
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("QUANTIZE_OPT", "DEPLOY_ACCUM", "CELL_OVERRIDES"):
                out[name] = eval(compile(ast.Expression(node.value), path,
                                         "eval"), {"dict": dict})
    return out


def test_dryrun_knobs_are_the_reference_s():
    ref = _reference_constants()
    assert dryrun.QUANTIZE_OPT == ref["QUANTIZE_OPT"]
    assert dryrun.DEPLOY_ACCUM == ref["DEPLOY_ACCUM"]
    assert dryrun.CELL_OVERRIDES == ref["CELL_OVERRIDES"]
    assert set(dryrun.VARIANTS) == {
        "baseline", "flashdecode", "moelocal", "qkvfused", "noseqshard",
        "blockq4k", "accum8", "expertpad", "deploy"}


@pytest.mark.parametrize("variant", sorted(dryrun.VARIANTS))
def test_dryrun_variants_resolve(variant):
    # the MoE variants apply to MoE archs only (the reference's raise on
    # the others, as these do)
    moe_only = variant in ("moelocal", "expertpad")
    for arch_id in (("olmoe-1b-7b",) if moe_only else
                    ("qwen3-14b", "olmoe-1b-7b", "zamba2-7b")):
        rec = dryrun.cell_record(arch_id, "decode_32k", True, variant)
        assert rec["status"] == "ok"
        assert rec["bytes_per_device"]["total"] > 0


def test_config_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(JModelConfig)]
    assert [f.name for f in dataclasses.fields(MoeCfg)] == [
        f.name for f in dataclasses.fields(JMoeCfg)]
    for arch_id in ARCH_IDS:
        jcfg, cfg = jget_config(arch_id), get_config(arch_id)
        for f in ("scan_layers", "seq_shard", "serve_params_tp_only"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch_id, f)
        if cfg.moe is not None:
            assert cfg.moe.dispatch == jcfg.moe.dispatch == "ep"


def test_resolve_examples():
    m = MeshShape((16, 16), ("data", "model"))
    assert resolve(m, ("fsdp", "tp"), (5120, 17408)) == P("data", "model")
    assert shard_shape(m, P("data", "model"), (5120, 17408)) == (320, 1088)
    pod = MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert resolve(pod, ("dp", None, "tp"), (32, 7, 40)) == P(
        ("pod", "data"), None, None)
    assert resolve(pod, ("fsdp", "tp"), (64, 32), {"fsdp": None}) == P(
        None, "model")
    assert dp_size(pod) == 32 and dp_size(m) == 16
    assert repr(P(("pod", "data"), None)) == "P(('pod', 'data'), None)"


def test_placements_shard_major_first():
    from torch.distributed.tensor import Replicate, Shard
    pod = MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert placements(pod, P(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(pod, P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(pod, P(("data", "pod")))      # not in the mesh's order
    with pytest.raises(ValueError):
        placements(pod, P("model", "model"))     # one mesh dim, two dims
    # a mesh dim of size 1 replicates
    m = MeshShape((4, 1), ("data", "model"))
    assert placements(m, P("data", "model")) == (Shard(0), Replicate())


def test_abstract_params_shard_bytes():
    m = MeshShape((2, 2), ("data", "model"))
    cfg = get_config("yi-9b", reduced=True)
    ab = abstract_params(make_arch(cfg).param_specs(cfg), m)
    embed = ab["embed"]
    assert embed.shape == (cfg.vocab, cfg.d_model)
    assert embed.shard_shape == (cfg.vocab // 2, cfg.d_model // 2)
    assert embed.shard_bytes == cfg.vocab * cfg.d_model // 4 * 2
    assert abstract_params(make_arch(cfg).param_specs(cfg), None)[
        "embed"].sharding is None


def test_meshes_are_shapes_until_built():
    assert production_mesh_shape().size == 256
    assert production_mesh_shape(multi_pod=True).axis_names == (
        "pod", "data", "model")
    assert stencil_mesh_shape(2).shape == {"sx": 16, "sy": 16}
    assert stencil_mesh_shape(3, multi_pod=True).size == 512
    with pytest.raises(RuntimeError):      # no process group here
        build(production_mesh_shape(), device="cpu")


def test_shard_ctx_without_mesh_is_identity():
    ctx = ShardCtx()
    x = torch.ones(2, 3)
    assert ctx.constrain(x, "dp", "tp") is x
    assert ctx.place(x, "dp", None) is x
    assert ctx.pspec("dp") is None and ctx.sharding("tp") is None
    with pytest.raises(TypeError):         # shapes only, no devices
        ShardCtx(MeshShape((2, 2), ("data", "model"))).constrain(x, "dp")
