"""The port's graph walker and roofline (``repro_torch.roofline``) vs
``FlopCounterMode`` and the reference's ``repro.roofline``.

* FLOPs: the walker's registry count on a traced graph equals
  ``FlopCounterMode``'s on a loop-free plain function and on a reduced
  qwen3 forward; on a fake (2, 4) world a tensor-parallel product counts
  a quarter of its unsharded FLOPs per device and a replicated one
  counts whole.
* Collectives: every kind DTensor issues on the (2, 4) world (all-reduce,
  all-gather, reduce-scatter, all-to-all) with its operand bytes, its
  group size read from the graph and its wire bytes at the reference's
  ring multipliers (``repro.roofline.hlo_walk._wire_multiplier``); the
  link a group crosses.
* The same sharded matmul and sum over one axis through the reference's
  ``walk_jit`` (a subprocess with eight forced XLA host devices) and
  ``graph_walk.walk_fn``: equal dot FLOPs, equal collective operand bytes.
* ``stencil_roofline`` equal to the reference's; ``build_roofline``'s
  model FLOPs, useful-FLOPs ratio and bottleneck rule against the
  reference's at the same totals and rates.
* The liveness walk: the peak and the memory split of a graph whose
  peak is known, and the peak below the no-free sum.
* The walker's table of collective ops against every op
  ``CommDebugMode`` counts, each op's kind read from its name as phase
  2m (iv) of ``chip_smoke.py`` reads it (``tests/_lm_chip.py``
  ``comm_kind``).

The fake world is this process's, torn down when the module ends.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline import analysis as janalysis
from repro.roofline import hlo_walk
from repro_torch.roofline import analysis, graph_walk
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _comm_debug_ops() -> list:
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
    return sorted({str(op) for op in c10d_collective_ops}
                  | {str(op) for op in CommDebugMode().comm_registry})


def _counted(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def test_flops_equal_flop_counter_plain():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(16, 32, generator=g), torch.randn(32, 8, generator=g)
    c = torch.randn(3, 5, 7, generator=g)
    bias = torch.randn(8, generator=g)

    def fn(a, b, c, bias):
        x = torch.addmm(bias, a, b)
        y = torch.relu(a @ b).sum(0)
        z = torch.bmm(c, c.transpose(1, 2))
        w = torch.baddbmm(z, c, c.transpose(1, 2))
        img = torch.nn.functional.conv2d(c[None], torch.ones(2, 3, 2, 2))
        return x, y, w.sum(), img
    t = graph_walk.walk_fn(fn, a, b, c, bias)
    assert t.flops == _counted(fn, a, b, c, bias) > 0


def test_flops_equal_flop_counter_reduced_qwen3_forward():
    from repro_torch.configs import get_config
    from repro_torch.models import make_arch
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.sharding import ShardCtx
    cfg = get_config("qwen3-14b", reduced=True)
    arch = make_arch(cfg)
    params = init_params(torch.Generator().manual_seed(1),
                         arch.param_specs(cfg), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    leaves = list(tree_leaves(params, torch.is_tensor))

    def loss(*xs):
        it = iter(xs[:-1])
        p = tree_map(lambda _: next(it), params, torch.is_tensor)
        with torch.no_grad():
            return arch.loss(p, {"tokens": xs[-1]}, cfg, ShardCtx())[0]
    want = _counted(loss, *leaves, toks)
    assert want > 0
    assert graph_walk.walk_fn(loss, *leaves, toks).flops == want


@pytest.fixture(scope="module")
def world():
    """A fake world of eight ranks and its (2, 4) mesh, torn down at the
    end of the module."""
    from repro_torch.sharding import MeshShape
    mesh = dryrun.fake_mesh(MeshShape((2, 4), ("data", "model")))
    yield mesh
    dryrun.end_fake_world()


def _sharded(mesh, fn, *leaves):
    """Walk ``fn`` on DTensors of ``leaves`` ((shape, placements) pairs)
    on ``mesh``."""
    spec = {f"x{i}": dryrun._Leaf(shape, torch.float32, mesh, places)
            for i, (shape, places) in enumerate(leaves)}
    with dryrun.traceable_dtensor():
        gm = dryrun.trace_sharded(
            lambda **kw: fn(*(kw[f"x{i}"] for i in range(len(leaves)))),
            spec)
    return graph_walk.walk(gm, 8, ranks_per_node=4), gm


def test_tp_product_counts_a_quarter(world):
    from torch.distributed.tensor import Replicate, Shard
    b, k, n = 16, 32, 64
    rep = (Replicate(), Replicate())
    t, _ = _sharded(world, lambda x, w: x @ w, ((b, k), rep),
                    ((k, n), (Replicate(), Shard(1))))
    assert t.flops == 2 * b * k * n / 4
    assert not t.coll_count
    t, _ = _sharded(world, lambda x, w: x @ w, ((b, k), rep), ((k, n), rep))
    assert t.flops == 2 * b * k * n


def _redistribute(src, dst):
    return lambda x: x.redistribute(x.device_mesh, dst).to_local()


@pytest.mark.parametrize("kind,src,dst,shape", [
    ("all-reduce", ("P", "R"), ("R", "R"), (8, 12)),
    ("all-reduce", ("R", "P"), ("R", "R"), (8, 12)),
    ("all-gather", ("R", "S0"), ("R", "R"), (8, 12)),
    ("all-gather", ("S1", "R"), ("R", "R"), (8, 12)),
    ("reduce-scatter", ("R", "P"), ("R", "S0"), (8, 12)),
    ("all-to-all", ("R", "S0"), ("R", "S1"), (8, 12)),
])
def test_collective_wire_bytes_match_reference(world, kind, src, dst,
                                               shape):
    from torch.distributed.tensor import Partial, Replicate, Shard

    def pl(names):
        return tuple({"R": Replicate(), "P": Partial()}.get(
            n, Shard(int(n[1:])) if n.startswith("S") else None)
            for n in names)
    t, gm = _sharded(world, _redistribute(None, pl(dst)), (shape, pl(src)))
    g = 2 if "R" == src[1] and src[0] != "R" else 4
    assert set(t.coll_count) == {kind}, graph_walk.count_nodes(gm)
    assert t.coll_count[kind] == 1
    local = [n for n in gm.graph.nodes if n.op == "placeholder"][0]
    lb = local.meta["val"].numel() * 4
    assert t.coll_operand[kind] == lb
    assert t.coll_wire[kind] == lb * hlo_walk._wire_multiplier(kind, g)
    # ranks_per_node=4: the model group (ranks 0-3) stays in one node,
    # the data group (ranks 0, 4) crosses two
    assert set(t.coll_link) == {"nvlink" if g == 4 else "network"}


@pytest.mark.parametrize("kind", list(graph_walk.COLLECTIVES) + ["other"])
@pytest.mark.parametrize("g", [1, 2, 3, 8, 16, 512])
def test_wire_multiplier_is_the_reference(kind, g):
    assert graph_walk._wire_multiplier(kind, g) == \
        hlo_walk._wire_multiplier(kind, g)


_JAX_PROBE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.roofline import hlo_walk
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
B, K, N = 32, 64, 128
xs = jax.ShapeDtypeStruct((B, K), jnp.float32,
                          sharding=NamedSharding(mesh, P("data", None)))
ws = jax.ShapeDtypeStruct((K, N), jnp.float32,
                          sharding=NamedSharding(mesh, P(None, "model")))
def mm_sum(x, w):
    return jax.lax.with_sharding_constraint(
        (x @ w).sum(axis=1), NamedSharding(mesh, P("data")))
a = hlo_walk.walk_jit(lambda x, w: x @ w, xs, ws, n_devices=8)
b = hlo_walk.walk_jit(mm_sum, xs, ws, n_devices=8)
print(json.dumps({"mm_flops": a.flops, "ops": b.collective_ops()}))
"""


def test_sharded_matmul_and_sum_match_walk_jit(world):
    from torch.distributed.tensor import Replicate, Shard
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    B, K, N = 32, 64, 128
    leaves = (((B, K), (Shard(0), Replicate())),
              ((K, N), (Replicate(), Shard(1))))
    t, _ = _sharded(world, lambda x, w: (x @ w).to_local(), *leaves)
    assert t.flops == ref["mm_flops"] == 2 * (B // 2) * K * (N // 4)

    def mm_sum(x, w):
        s = (x @ w).sum(1)
        return s.redistribute(s.device_mesh,
                              (Shard(0), Replicate())).to_local()
    t, _ = _sharded(world, mm_sum, *leaves)
    assert set(t.coll_operand) == set(ref["ops"]) == {"all-reduce"}
    assert t.coll_operand["all-reduce"] == \
        ref["ops"]["all-reduce"]["operand_bytes"]
    assert t.coll_count["all-reduce"] == ref["ops"]["all-reduce"]["count"]


@pytest.mark.parametrize("flops,byts,secs,bw,peak", [
    (1e9, 4e9, 2e-3, 3e12, 989e12), (5e12, 1e9, 1.0, 2e12, 67e12),
    (0.0, 1e6, 0.0, 0.0, 0.0), (3e9, 3e9, 1e-3, 3e12, 3e12)])
def test_stencil_roofline_is_the_reference(flops, byts, secs, bw, peak):
    kw = dict(flops=flops, bytes_moved=byts, measured_s=secs,
              measured_bw=bw, peak_flops=peak)
    assert analysis.stencil_roofline(**kw) == janalysis.stencil_roofline(**kw)


@pytest.mark.parametrize("arch,cell", [
    ("qwen3-14b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
    ("yi-9b", "prefill_32k")])
@pytest.mark.parametrize("flops,byts,wire", [
    (1e15, 1e12, 1e9), (1e12, 5e13, 1e9), (1e12, 1e11, 5e12),
    (2e12, 2e12 * janalysis.HBM_BW / janalysis.PEAK_FLOPS_BF16, 0.0)])
def test_build_roofline_against_reference(arch, cell, flops, byts, wire):
    from repro.configs import get_config as jget
    from repro.models import CELLS as JCELLS
    from repro_torch.configs import get_config
    from repro_torch.models import CELLS
    jt = hlo_walk.Totals(flops=flops, bytes=byts,
                         coll_wire={"all-reduce": wire})
    t = graph_walk.Totals(flops=flops, bytes=byts,
                          coll_wire={"all-reduce": wire},
                          coll_link={"network": wire})
    jr = janalysis.build_roofline(arch, JCELLS[cell], "m", 256, jt, {},
                                  jget(arch))
    r = analysis.build_roofline(arch, CELLS[cell], "m", 256, t, {},
                                get_config(arch))
    assert r.model_flops == pytest.approx(jr.model_flops, rel=1e-12)
    assert r.useful_flops_ratio == pytest.approx(jr.useful_flops_ratio,
                                                 rel=1e-12)
    # the bottleneck rule at the reference's own rates
    terms = analysis.roofline_terms(
        flops, byts, {"ici": wire}, peak_flops=janalysis.PEAK_FLOPS_BF16,
        hbm_bw=janalysis.HBM_BW,
        link_bw={"ici": janalysis.ICI_LINKS * janalysis.ICI_LINK_BW})
    assert analysis.bottleneck_of(terms) == jr.bottleneck
    for k, v in (("compute", jr.t_compute), ("memory", jr.t_memory),
                 ("collective", jr.t_collective)):
        assert terms[k] == pytest.approx(v, rel=1e-12)
    # at the H100's data-sheet rates
    assert r.t_compute == flops / 989e12
    assert r.t_memory == byts / 3.35e12
    assert r.t_collective == wire / 50e9
    assert set(r.summary()) >= set(jr.summary())


def test_liveness_peak_on_a_known_graph():
    x = torch.ones(256)                        # 1 KiB

    def fn(x):
        y = x + 1                              # 1 KiB, dies at z
        z = y * 2                              # 1 KiB, dies at cat
        w = z.view(16, 16)                     # alias of z
        v = torch.cat([w, w])                  # 2 KiB, dies at the sum
        return v.sum()                         # 4 B, the output
    gm = graph_walk.trace(fn, x)
    m = graph_walk.memory_split(gm)
    assert m == {"argument_size_in_bytes": 1024.0,
                 "output_size_in_bytes": 4.0, "alias_size_in_bytes": 0.0,
                 "temp_size_in_bytes": 3072.0, "peak_bytes": 4096.0}
    # an in-place update of an argument is an alias, not an output
    gm = graph_walk.trace(lambda x: x.mul_(2), x.clone())
    m = graph_walk.memory_split(gm)
    assert m["alias_size_in_bytes"] == 1024.0
    assert m["output_size_in_bytes"] == 0.0


def test_liveness_frees():
    """A chain of 20 temporaries of 4 KiB: the peak holds two of them
    beside the argument, never all twenty."""
    def fn(x):
        for _ in range(20):
            x = x * 1.5
        return x.sum()
    gm = graph_walk.trace(fn, torch.ones(1024))
    m = graph_walk.memory_split(gm)
    assert m["peak_bytes"] == 3 * 4096
    assert m["temp_size_in_bytes"] == 2 * 4096


def test_bytes_model():
    """Operands plus result per node; views and detach are free."""
    def fn(a, b):
        c = a.t()                              # a view: free
        d = c @ b                              # 8x8 @ 8x4 -> 8x4
        return d.detach().sum()
    a, b = torch.ones(8, 8), torch.ones(8, 4)
    t = graph_walk.walk_fn(fn, a, b)
    assert t.bytes == (64 + 32 + 32) * 4 + (32 * 4 + 4)
    assert t.flops == 2 * 8 * 8 * 4


def test_totals_extended():
    a = graph_walk.Totals(flops=10, bytes=100, coll_count={"x": 1},
                          memory={"peak_bytes": 50})
    b = graph_walk.Totals(flops=13, bytes=120, coll_count={"x": 3},
                          memory={"peak_bytes": 60})
    e = a.extended(b, 4)
    assert (e.flops, e.bytes, e.coll_count["x"], e.memory["peak_bytes"]) \
        == (22, 180, 9, 90)


def test_hardware_table_is_the_data_sheet():
    h = analysis.HARDWARE["H100"]
    assert (h["bf16"], h["hbm_bw"], h["nvlink_bw"], h["network_bw"]) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert h["hbm_bytes"] == 80 * 2**30 and h["ranks_per_node"] == 8
    assert dataclasses.is_dataclass(analysis.Roofline)


@pytest.mark.parametrize("op", _comm_debug_ops())
def test_walker_files_every_collective_comm_debug_counts(op):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from _lm_chip import comm_kind
    finally:
        sys.path.pop(0)
    kind = comm_kind(op)
    filed = graph_walk._COLLECTIVE_OPS.get(op.rpartition(".")[2])
    assert filed == kind
    # the rooted ops (gather, reduce, scatter) have no kind in the
    # reference's model and stay unfiled; every other op has one
    assert kind is not None or op.rpartition(".")[2] in (
        "gather_", "reduce_", "scatter_")
