"""The distributed stencil path of the port against the reference's.

The port runs in spawned worlds of CPU ranks joined over gloo
(``tests/_dist_world.py``): eight ranks for the parity matrix, one for
the plan-level cases.  The reference runs in one subprocess with eight
forced host devices and x64 on: ``repro.core.distributed_stencil_fn``
("ref" on every case, "pallas" in interpret mode on a few) and its
single-device oracle on the same seeded numpy grids.  f64 is held
bitwise, f32 within the reference tests' ``atol=1e-4``.  Exchange rounds
(``repro_torch.core.halo.EXCHANGE``) stand in for the collective-permute
count the reference's tests read from its HLO; on a CPU tensor the
kernels' wrappers run their plain versions, which count no launch.
"""
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location(
    "_dist_world", os.path.join(HERE, "_dist_world.py"))
world = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(world)

CASES = {c["key"]: c for c in world.cases()}
F32_ATOL = 1e-4

_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
import _dist_world as w
import repro.core as rc
from repro.core import ref as cref

out = {{}}
for case in w.cases():
    spec = w.build_spec(case["desc"], rc)
    mesh = jax.make_mesh(case["mesh"], w.mesh_names(case))
    g = jnp.asarray(w.grid_for(case))
    gs = jax.device_put(g, NamedSharding(mesh, P(*case["axes"])))
    for backend in ("ref", "pallas"):
        if backend == "pallas" and case["key"] not in w.PALLAS_KEYS:
            continue
        fn = rc.distributed_stencil_fn(
            spec, mesh, case["axes"], iters=case["iters"],
            sweeps=case["sweeps"], backend=backend)
        out[case["key"] + "/" + backend] = np.asarray(fn(gs))
    if case["desc"][0] == "stencil":
        oracle = cref.run_iterations(spec, g, case["iters"])
    else:
        oracle = cref.run_pipeline(spec, g, case["iters"])
    out[case["key"] + "/oracle"] = np.asarray(oracle)
g = jnp.asarray(np.random.default_rng(2).standard_normal((32, 64))
                .astype(np.float32))
for key, iters in (("engine/inherit", 7), ("engine/override", 2)):
    out[key + "/oracle"] = np.asarray(
        cref.run_iterations(rc.jacobi2d(), g, iters))
np.savez({path!r}, **out)
print("reference ok", len(out))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's run and the port's eight-rank world, side by
    side: ``(port results, port rank records, reference results)``."""
    tmp = tmp_path_factory.mktemp("dist")
    ref_path = str(tmp / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE).format(
            tests=HERE, path=ref_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        records = world.run_world("parity", 8, str(tmp / "port"),
                                  timeout=300)
        text, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, text[-6000:]
    port = dict(np.load(tmp / "port" / "results.npz"))
    return port, records, dict(np.load(ref_path))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The one-rank world's checks."""
    return world.run_world("single", 1,
                           str(tmp_path_factory.mktemp("single")),
                           timeout=120)[0]["checks"]


def _match(got, want, dtype, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if dtype == "float64":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0,
                                   err_msg=what)


def _port_oracle(case):
    import torch
    import repro_torch as rt
    spec = world.build_spec(case["desc"], rt)
    g = torch.from_numpy(world.grid_for(case))
    if case["desc"][0] == "stencil":
        return rt.run_iterations(spec, g, case["iters"]).numpy()
    from repro_torch.core import ref as tref
    return tref.run_pipeline(spec, g, case["iters"]).numpy()


def _hold(worlds, key, backends=("ref", "cuda")):
    """Every port backend's gathered result of ``key`` against the
    reference's distributed run(s), its oracle and the port's oracle."""
    port, _, ref = worlds
    case = CASES[key]
    oracle = ref[f"{key}/oracle"]
    _match(_port_oracle(case), oracle, case["dtype"], f"{key}: port oracle")
    for backend in backends:
        got = port[f"{key}/{backend}"]
        _match(got, oracle, case["dtype"], f"{key}/{backend} vs oracle")
        _match(got, ref[f"{key}/ref"], case["dtype"],
               f"{key}/{backend} vs reference 'ref'")
        if f"{key}/pallas" in ref:
            _match(got, ref[f"{key}/pallas"], case["dtype"],
                   f"{key}/{backend} vs reference 'pallas'")
    return port, ref


def _rank_cases(worlds, key):
    return [rec["cases"][key] for rec in worlds[1]]


@pytest.mark.parametrize("name", world.PAPER)
def test_halo_exchange_equals_global_stencil(worlds, name):
    _hold(worlds, f"global/{name}")


@pytest.mark.parametrize("name", [c[0] for c in world.TEMPORAL])
def test_distributed_temporal_blocking_matches_oracle(worlds, name):
    """Fused steps over multi-hop gathers (7pt1d: 12 deep on 4-wide
    shards), a sliver mesh and remainders, on the oracle's window core,
    the kernels' plain versions and ``tile="auto"`` (tuned on the shard
    shape)."""
    key = f"temporal/{name}"
    _hold(worlds, key, ("ref", "cuda", "cuda/auto"))
    # tuned on mesh rank 0 and broadcast: one tile on every rank
    tiles = {tuple(rc["tile"]) for rc in _rank_cases(worlds,
                                                     f"{key}/cuda/auto")}
    assert len(tiles) == 1, tiles


@pytest.mark.parametrize("boundary", world.BOUNDARIES)
@pytest.mark.parametrize("name", [c[0] for c in world.BOUNDARY])
def test_distributed_boundary_modes_bit_identical(worlds, name, boundary):
    """f64 bitwise for every mode, the periodic wrap ring crossing
    several ranks and the sliver mesh's self pairs included."""
    key = f"boundary/{name}/{boundary}"
    _hold(worlds, key)
    strategy = {"zero": "zero-fill", "periodic": "wrap-ring"}.get(
        boundary, "edge-fixup")
    for rc in _rank_cases(worlds, f"{key}/cuda"):
        assert strategy in rc["exchange"]


def test_distributed_fused_equals_chained_and_fewer_launches(worlds):
    """sweeps=4 is f64 bit-identical to four chained sweeps=1 steps and to
    the oracle, and takes at most a third of their exchange rounds."""
    port, ref = _hold(worlds, "fused/t4")
    _hold(worlds, "fused/t1")
    for backend in ("ref", "cuda"):
        np.testing.assert_array_equal(port[f"fused/t4/{backend}"],
                                      port[f"fused/t1/{backend}"])
        for fused, chained in zip(_rank_cases(worlds, f"fused/t4/{backend}"),
                                  _rank_cases(worlds,
                                              f"fused/t1/{backend}")):
            assert fused["rounds"] > 0
            assert chained["rounds"] >= 3 * fused["rounds"], (chained,
                                                             fused)


def test_periodic_wrap_ring_has_no_extra_launches(worlds):
    """The periodic wrap ring takes as many exchange rounds as the zero
    boundary's exchange on every rank: the ring changes the peers, not
    the round count."""
    _hold(worlds, "ring/zero")
    _hold(worlds, "ring/periodic")
    for zero, ring in zip(_rank_cases(worlds, "ring/zero/cuda"),
                          _rank_cases(worlds, "ring/periodic/cuda")):
        assert ring["rounds"] == zero["rounds"] > 0


def test_predicted_rounds_and_launches_match_the_counters(worlds):
    """Per rank and case: the rounds counted equal the launch lint's
    ``predicted_exchange_rounds``; a ``"cuda"`` plan predicts one
    K2/K4 per fused step (the plain versions here count none)."""
    for rec in worlds[1]:
        for key, rc in rec["cases"].items():
            assert rc["rounds"] == rc["predicted_rounds"], (rec["rank"], key)
            assert rc["launches"] == {}, key
            if "/cuda" in key and CASES[key.split("/cuda")[0]]["iters"]:
                assert set(rc["predicted_launches"]) <= {"K1", "K2", "K4"}
                assert rc["predicted_launches"], key


def test_engine_distributed_fn_inherits_engine_options(worlds):
    """``CasperEngine.distributed_fn`` runs the engine's sweeps (3),
    backend and tile ("auto"), decomposing iters=7 as 2*3 + 1, and a
    call's override (sweeps=1, backend="ref") wins."""
    port, records, ref = worlds
    _match(port["engine/inherit"], ref["engine/inherit/oracle"], "float32",
           "engine/inherit")
    _match(port["engine/override"], ref["engine/override/oracle"],
           "float32", "engine/override")
    plans = {tuple(p) for p in records[0]["checks"]["engine/plans"][1]}
    assert {("cuda", 3, "auto"), ("cuda", 1, "auto"),
            ("ref", 1, "None")} <= plans
    assert records[0]["checks"]["engine/lowered"][0]


def test_deep_halo_exchange_validation(worlds):
    """sweeps/iters/backend/grid_axes validation, an indivisible grid,
    and the zero-iters identity: a copy of the shard, never the shard."""
    port, records, _ = worlds
    for rec in records:
        assert rec["checks"]["validation/raises"][0], rec["checks"]
        assert rec["checks"]["validation/indivisible"][0], rec["checks"]
        for backend in ("ref", "cuda"):
            assert not rec["cases"][f"identity/jacobi2d/{backend}"][
                "same_storage"]
    for backend in ("ref", "cuda"):
        np.testing.assert_array_equal(
            port[f"identity/jacobi2d/{backend}"],
            world.grid_for(CASES["identity/jacobi2d"]))


def test_multihop_past_the_mesh_edge_is_a_verifier_warning(worlds):
    for rec in worlds[1]:
        assert rec["checks"]["validation/multihop_warning"][1] == [
            ["distributed", "warning"]]


@pytest.mark.parametrize("key", ["pipeline/reaction_diffusion2d",
                                 "pipeline/advect_diffuse2d",
                                 "pipeline/rd_fused", "pipeline/staged"])
def test_distributed_pipelines_match_reference(worlds, key):
    """The paper chains (a fused step exchanges ``sweeps * sum(stage
    radii)`` once), and a chain that cannot fuse (per-stage distributed
    plans, which carry the exchange), f64 bitwise."""
    _hold(worlds, key)
    for rc in _rank_cases(worlds, f"{key}/cuda"):
        assert (rc["exchange"] is None) == (key == "pipeline/staged")


def test_distributed_structure_parity(worlds):
    """A separable spec (blur2d, reflect) keeps its factored order on the
    shard: f64 bitwise, one dim sharded, the other padded locally."""
    _hold(worlds, "structure/blur2d")


@pytest.mark.parametrize("boundary", world.BOUNDARIES)
@pytest.mark.parametrize("mesh", ["(8,)", "(2, 4)"])
def test_exchange_halo_1axis_equals_the_padded_grid(worlds, mesh, boundary):
    """Every rank's exchanged block equals its window of the global
    grid's ``pad_boundary``, one hop and three (a halo past two shards),
    along dim 0 on a ring of 8 and dim 1 on a ring of 4; the rounds are
    two per hop that has a peer."""
    for rec in worlds[1]:
        found = {k: v for k, v in rec["checks"].items()
                 if k.startswith(f"exchange/{mesh}/{boundary}/")}
        assert len(found) == 2
        assert all(v[0] for v in found.values()), found


def test_exchange_self_pairs_and_zero_fill(worlds):
    """On a mesh dim of one rank, a periodic 12-deep halo on a 5-wide
    block is six self pairs (local copies); a zero boundary fills zeros
    and sends nothing."""
    for rec in worlds[1]:
        assert rec["checks"]["exchange/self_pairs"][0], rec["checks"]
        assert rec["checks"]["exchange/zero_fill_past_edge"][0]


def test_sharding_for_and_shard_helpers(worlds):
    for rec in worlds[1]:
        assert rec["checks"]["helpers/sharding_for"][0], rec["checks"]


def test_cache_key_includes_mesh_fingerprint(single):
    """A mesh plan is not the single-device plan; its fingerprint (dim
    names, shape, global ranks, grid_axes) is in the key, so the same
    mesh hits; it records its exchange and shard shape and no budget."""
    assert single["plan/key"][0], single["plan/key"]
    assert single["plan/cuda"][0], single["plan/cuda"]


def test_distributed_backend_executes_plan(single):
    """``plan.execute`` runs one fused distributed step (wrap ring on a
    one-rank mesh: self pairs) equal to the oracle; the halo executor
    refuses a single-device plan."""
    assert single["plan/execute"][0]


def test_rank_failure_fails_the_world(tmp_path):
    """A rank that raises fails the world: the launcher stops the rank
    waiting for it and raises with the failing rank's output."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        world.run_world("fail", 2, str(tmp_path), timeout=120)
