"""Worlds of local ranks for the distributed stencil path.

    python tests/_dist_world.py --rank R --world N --port P --out DIR \\
        --suite parity|single|fail|chip [--device cpu|cuda]

One process per rank, joined over gloo (``tcp://127.0.0.1:P``), each
running the same suite on its own shard and writing
``DIR/rank<R>.json`` (rank 0 also ``DIR/results.npz``, the gathered
global grids).  :func:`run_world` starts the ranks, waits for them with a
timeout and raises, after stopping the others, when one fails.

The case tables (:func:`cases`) and :func:`build_spec`
import numpy alone, so that the reference's run (JAX, in its own
process) and the port's ranks draw the same grids from the same seeds;
``tests/test_torch_distributed.py`` holds the two against each other on
the CPU, and ``chip_smoke.py`` runs the ``"chip"`` suite on the card:
eight ranks with their shards on one device (the mesh is built on
``"cpu"``, so gloo carries the exchanges through pinned host buffers).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

BOUNDARIES = ("zero", "constant(0.5)", "periodic", "reflect")
PAPER = ("jacobi1d", "7pt1d", "jacobi2d", "blur2d", "heat3d", "star33_3d")
GLOBAL_SHAPES = {1: (512,), 2: (64, 48), 3: (16, 12, 10)}
NDIM = {"jacobi1d": 1, "7pt1d": 1, "jacobi2d": 2, "blur2d": 2, "heat3d": 3,
        "star33_3d": 3}
MESH_NAMES = ("sx", "sy")

# name, shape, mesh, grid_axes, sweeps, iters: the reference's temporal
# blocking cases (tests/test_distributed.py) — 7pt1d gathers a 12-deep
# halo from 4-wide shards (3 hops), blur2d runs on a sliver mesh whose
# sx has one rank (a self pair under periodic)
TEMPORAL = (
    ("jacobi1d", (64,), (8,), ("sx",), 4, 9),
    ("7pt1d", (32,), (8,), ("sx",), 4, 8),
    ("jacobi2d", (32, 48), (4, 2), ("sx", "sy"), 4, 7),
    ("blur2d", (16, 48), (1, 8), ("sx", "sy"), 4, 5),
    ("heat3d", (16, 16, 8), (4, 2), ("sx", "sy", None), 4, 6),
    ("star33_3d", (8, 16, 10), (2, 4), ("sx", "sy", None), 3, 4),
)
# the reference's boundary matrix: each case x BOUNDARIES
BOUNDARY = (
    ("jacobi1d", (64,), (8,), ("sx",), 4, 9),
    ("7pt1d", (32,), (8,), ("sx",), 4, 8),
    ("jacobi2d", (32, 48), (4, 2), ("sx", "sy"), 4, 7),
    ("blur2d", (16, 48), (1, 8), ("sx", "sy"), 3, 5),
    ("heat3d", (16, 16, 8), (4, 2), ("sx", "sy", None), 4, 6),
)


def _case(key, desc, shape, mesh, axes, sweeps, iters, dtype, seed):
    return {"key": key, "desc": desc, "shape": tuple(shape),
            "mesh": tuple(mesh), "axes": tuple(axes), "sweeps": sweeps,
            "iters": iters, "dtype": dtype, "seed": seed}


def cases(dtype_of_f32: str = "float32") -> list[dict]:
    """Every case of the parity matrix, in the reference tests' groups:
    ``global/`` (the six paper stencils, three sweeps), ``temporal/``,
    ``boundary/`` (f64), ``fused/`` (sweeps 4 against 1, f64), ``ring/``
    (zero against periodic rounds), ``pipeline/`` (the paper chains, a
    fused reaction_diffusion2d at sweeps 4 and a staged chain, f64),
    ``structure/`` (blur2d reflect, f64) and ``identity/`` (iters 0).
    ``dtype_of_f32`` replaces the groups' float32 (the card's run takes
    every case in float64)."""
    f32 = dtype_of_f32
    out = []
    for name in PAPER:
        nd = NDIM[name]
        mesh = (8,) if nd == 1 else (4, 2)
        axes = (("sx",), ("sx", "sy"), ("sx", "sy", None))[nd - 1]
        out.append(_case(f"global/{name}", ("stencil", name, None),
                         GLOBAL_SHAPES[nd], mesh, axes, 1, 3, f32,
                         len(out)))
    for name, shape, mesh, axes, t, iters in TEMPORAL:
        out.append(_case(f"temporal/{name}", ("stencil", name, None), shape,
                         mesh, axes, t, iters, f32, len(out)))
    for name, shape, mesh, axes, t, iters in BOUNDARY:
        for b in BOUNDARIES:
            out.append(_case(f"boundary/{name}/{b}", ("stencil", name, b),
                             shape, mesh, axes, t, iters, "float64",
                             len(out)))
    for t in (4, 1):
        out.append(_case(f"fused/t{t}", ("stencil", "jacobi2d", None),
                         (32, 48), (4, 2), ("sx", "sy"), t, 4, "float64",
                         1000))
    for b in ("zero", "periodic"):
        out.append(_case(f"ring/{b}", ("stencil", "jacobi2d", b), (32, 48),
                         (4, 2), ("sx", "sy"), 4, 4, f32, 1001))
    for name in ("reaction_diffusion2d", "advect_diffuse2d"):
        out.append(_case(f"pipeline/{name}", ("pipeline", name), (16, 24),
                         (4, 2), ("sx", "sy"), 1, 3, "float64", len(out)))
    out.append(_case("pipeline/rd_fused", ("pipeline",
                                           "reaction_diffusion2d"),
                     (32, 64), (4, 2), ("sx", "sy"), 4, 6, "float64",
                     len(out)))
    out.append(_case("pipeline/staged", ("chain", "mixed"), (32, 64),
                     (4, 2), ("sx", "sy"), 2, 3, "float64", len(out)))
    out.append(_case("structure/blur2d", ("stencil", "blur2d", "reflect"),
                     (32, 48), (4, 2), ("sx", None), 2, 4, "float64",
                     len(out)))
    out.append(_case("identity/jacobi2d", ("stencil", "jacobi2d", None),
                     (16, 8), (4, 2), ("sx", None), 4, 0, f32, len(out)))
    return out


#: The reference's Pallas backend (interpret mode) runs on these cases
#: too; its "ref" backend on all of them.
PALLAS_KEYS = ("temporal/jacobi2d", "boundary/jacobi1d/reflect",
               "pipeline/rd_fused")


def build_spec(desc, pkg):
    """The spec or chain ``desc`` names, from ``pkg`` (``repro.core`` or
    ``repro_torch``)."""
    kind = desc[0]
    if kind == "stencil":
        spec = pkg.PAPER_STENCILS[desc[1]]
        return spec if desc[2] is None else spec.with_boundary(desc[2])
    if kind == "pipeline":
        return pkg.PAPER_PIPELINES[desc[1]]
    # a chain that cannot fuse: a zero-boundary stage beside a periodic one
    return pkg.StencilPipeline("mixed", (pkg.jacobi2d(), pkg.advect2d()))


def grid_for(case) -> np.ndarray:
    """The case's global input, from its seed."""
    rng = np.random.default_rng(case["seed"])
    return rng.standard_normal(case["shape"]).astype(case["dtype"])


def mesh_names(case) -> tuple[str, ...]:
    return MESH_NAMES[:len(case["mesh"])]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(suite: str, world: int, out_dir: str, *, device: str = "cpu",
              timeout: float = 600.0, env: dict | None = None,
              script: str | None = None) -> list[dict]:
    """Run ``suite`` on ``world`` ranks (one process each) and return
    every rank's record.  Raises ``RuntimeError`` with the failing rank's
    output when a rank exits non-zero, and ``TimeoutError`` past
    ``timeout`` seconds; either way every rank still running is killed.
    ``script`` is the ranks' program (default: this file); it takes this
    file's arguments and writes ``out_dir/rank<R>.json``."""
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    penv = dict(os.environ if env is None else env)
    penv["PYTHONPATH"] = SRC + os.pathsep + penv.get("PYTHONPATH", "")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__),
             "--rank", str(rank),
             "--world", str(world), "--port", str(port), "--out", out_dir,
             "--suite", suite, "--device", device],
            stdout=log, stderr=subprocess.STDOUT, env=penv))
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.time() > deadline:
                raise TimeoutError(f"world {suite!r}: ranks still running "
                                   f"after {timeout:.0f}s")
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = bad[0] if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        # a rank that waited on the failed one fails too: show every one
        texts = []
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(out_dir, f"rank{rank}.log")) as fh:
                    texts.append(f"--- rank {rank} exited {p.returncode}:\n"
                                 + fh.read()[-3000:])
        raise RuntimeError(f"world {suite!r}: rank {failed} failed first\n"
                           + "\n".join(texts))
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as fh:
            out.append(json.load(fh))
    return out


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
class Rank:
    """One rank's state: its meshes (built once per shape, in the same
    order on every rank) and its record."""

    def __init__(self, rank, world, device):
        import torch
        import repro_torch as rt
        from repro_torch.core import halo
        self.torch, self.rt, self.halo = torch, rt, halo
        self.rank, self.world, self.device = rank, world, device
        self.meshes = {}
        self.record = {"rank": rank, "checks": {}, "cases": {}}

    def mesh(self, shape, names):
        from torch.distributed.device_mesh import init_device_mesh
        key = (tuple(shape), tuple(names))
        if key not in self.meshes:
            self.meshes[key] = init_device_mesh("cpu", key[0],
                                                mesh_dim_names=key[1])
        return self.meshes[key]

    def check(self, name, ok, detail=""):
        self.record["checks"][name] = [bool(ok), str(detail)]


def _run_case(r: Rank, case, backend, tile=None, keng=None):
    """One distributed run of ``case``: the shard in, the gathered global
    grid out (on every rank), with the rounds and launches it took."""
    torch, rt, halo = r.torch, r.rt, r.halo
    mesh = r.mesh(case["mesh"], mesh_names(case))
    spec = build_spec(case["desc"], rt)
    g = torch.from_numpy(grid_for(case))
    local = rt.shard_grid(g, mesh, case["axes"])
    fn = rt.distributed_stencil_fn(spec, mesh, case["axes"], case["iters"],
                                   sweeps=case["sweeps"], backend=backend,
                                   tile=tile, device=r.device)
    rounds0 = halo.EXCHANGE["rounds"]
    launches0 = dict(keng.LAUNCHES) if keng is not None else None
    out = fn(local)
    rounds = halo.EXCHANGE["rounds"] - rounds0
    launches = ({k: v - launches0[k] for k, v in keng.LAUNCHES.items()
                 if v != launches0[k]} if keng is not None else None)
    gathered = rt.gather_grid(out, mesh, case["axes"])
    return spec, mesh, g, local, out, gathered, rounds, launches


def _predicted(r: Rank, spec, mesh, case, backend, tile, dtype):
    from repro_torch.analysis import launch_lint
    from repro_torch.core import plan as tplan
    plan = tplan.lower(spec, case["shape"], dtype, backend=backend,
                       sweeps=case["sweeps"], tile=tile, device=r.device,
                       mesh=mesh, grid_axes=case["axes"])
    return (launch_lint.predicted_exchange_rounds(plan, case["iters"]),
            launch_lint.predicted_launches(plan, case["iters"]), plan)


def suite_parity(r: Rank, out_dir: str) -> None:
    """The parity matrix on the CPU: every case on ``"ref"`` and
    ``"cuda"`` (the kernels' plain versions on CPU tensors; the temporal
    cases also at ``tile="auto"``), each run's rounds and launches beside
    the launch lint's prediction; the engine's options; the validation;
    and the exchange's own checks."""
    from repro_torch.kernels import engine as keng
    torch, rt = r.torch, r.rt
    results = {}
    for case in cases():
        runs = [("ref", None), ("cuda", None)]
        if case["key"].startswith("temporal/"):
            runs.append(("cuda", "auto"))
        for backend, tile in runs:
            key = f"{case['key']}/{backend}" + ("/auto" if tile else "")
            spec, mesh, g, local, out, gathered, rounds, launches = \
                _run_case(r, case, backend, tile, keng)
            pr, pl, plan = _predicted(r, spec, mesh, case, backend, tile,
                                      g.dtype)
            results[key] = gathered.numpy()
            r.record["cases"][key] = {
                "rounds": rounds, "launches": launches,
                "predicted_rounds": pr, "predicted_launches": pl,
                "shard": list(local.shape), "tile": plan.tile,
                "exchange": plan.exchange,
                "same_storage": out.data_ptr() == local.data_ptr()}
    _engine_options(r, results)
    _validation(r)
    _exchange_checks(r)
    _helpers(r)
    if r.rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"), **results)


def _engine_options(r: Rank, results: dict) -> None:
    """``CasperEngine.distributed_fn`` takes the engine's sweeps, backend
    and tile, and a call's override wins."""
    torch, rt = r.torch, r.rt
    mesh = r.mesh((4, 2), MESH_NAMES)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (32, 64)).astype(np.float32))
    local = rt.shard_grid(g, mesh, ("sx", "sy"))
    eng = rt.CasperEngine(rt.jacobi2d(), backend="cuda", sweeps=3,
                          tile="auto", device=r.device)
    before = rt.PLAN_CACHE.stats()["misses"]
    out = eng.distributed_fn(mesh, ("sx", "sy"), iters=7)(local)
    plans = [k for k in rt.PLAN_CACHE.keys()
             if k[0] == eng.spec and k[1] == (32, 64) and k[-1] is not None]
    results["engine/inherit"] = rt.gather_grid(out, mesh,
                                               ("sx", "sy")).numpy()
    r.record["checks"]["engine/plans"] = [
        True, sorted((k[3], k[4], str(k[5])) for k in plans)]
    r.check("engine/lowered", rt.PLAN_CACHE.stats()["misses"] > before)
    out1 = eng.distributed_fn(mesh, ("sx", "sy"), iters=2, sweeps=1,
                              backend="ref")(local)
    results["engine/override"] = rt.gather_grid(out1, mesh,
                                                ("sx", "sy")).numpy()


def _validation(r: Rank) -> None:
    """sweeps/iters/grid_axes/backend validation, indivisible shapes and
    the zero-iters identity (a copy, never the input)."""
    torch, rt = r.torch, r.rt
    mesh = r.mesh((4, 2), MESH_NAMES)
    spec = rt.PAPER_STENCILS["jacobi2d"]
    raised = []
    for bad in ({"sweeps": 0}, {"iters": -1}, {"backend": "vm"}):
        try:
            rt.distributed_stencil_fn(spec, mesh, ["sx", None], **bad,
                                      device=r.device)
        except ValueError:
            raised.append(True)
        else:
            raised.append(False)
    try:
        rt.distributed_stencil_fn(spec, mesh, ["sx"], device=r.device)
    except ValueError:
        raised.append(True)
    else:
        raised.append(False)
    r.check("validation/raises", all(raised), raised)
    try:
        rt.core.plan.lower(spec, (18, 8), torch.float32, device=r.device,
                           mesh=mesh, grid_axes=("sx", None))
    except ValueError as e:
        r.check("validation/indivisible", "not divisible" in str(e), e)
    else:
        r.check("validation/indivisible", False, "no ValueError")
    # a deep halo that needs more hops than the mesh dim has shards, on a
    # non-ring exchange, is the verifier's warning (20 deep on 2-wide
    # shards of an 8-rank dim: 10 hops)
    from repro_torch import analysis
    plan = rt.core.plan.lower(rt.PAPER_STENCILS["jacobi1d"], (16,),
                              torch.float32, sweeps=20, device=r.device,
                              mesh=r.mesh((8,), ("sx",)), grid_axes=("sx",))
    r.record["checks"]["validation/multihop_warning"] = [True, [
        (f.check, f.severity) for f in analysis.verify_plan(plan).findings
        if f.check == "distributed"]]


def _helpers(r: Rank) -> None:
    """``sharding_for`` gives the DTensor placements of a layout;
    ``shard_grid`` and ``gather_grid`` are inverses."""
    torch, rt = r.torch, r.rt
    from torch.distributed.tensor import Replicate, Shard
    mesh = r.mesh((4, 2), MESH_NAMES)
    g = torch.arange(8 * 6 * 4, dtype=torch.float64).reshape(8, 6, 4)
    back = [rt.gather_grid(rt.shard_grid(g, mesh, axes), mesh, axes)
            for axes in (("sx", "sy", None), ("sy", None, "sx"))]
    r.check("helpers/sharding_for",
            rt.sharding_for(mesh, ("sx", None)) == (Shard(0), Replicate())
            and rt.sharding_for(mesh, (None, "sy", "sx"))
            == (Shard(2), Shard(1))
            and all(torch.equal(b, g) for b in back)
            and rt.shard_grid(g, mesh, ("sx", "sy", None)).shape == (2, 3, 4))


def _exchange_checks(r: Rank) -> None:
    """``exchange_halo_1axis`` against the global grid's own
    ``pad_boundary``: each boundary mode, one hop and three (a halo
    deeper than two shards), along dim 0 on a ring of 8 and along dim 1
    on a ring of 4 (a slice that is not contiguous); on a ring of 1, self
    pairs and zero-fill past the mesh's edge."""
    torch, rt, halo = r.torch, r.rt, r.halo
    from repro_torch.core import ref as tref
    from repro_torch.core.stencil import parse_boundary
    g = torch.arange(32 * 6, dtype=torch.float64).reshape(32, 6) + 1.0
    for mesh_shape, axis, grid in (((8,), 0, g), ((2, 4), 1, g.T)):
        names = MESH_NAMES[:len(mesh_shape)]
        mesh = r.mesh(mesh_shape, names)
        name = names[axis]
        axes = [None] * grid.ndim
        axes[axis] = name
        local = rt.shard_grid(grid, mesh, axes)
        size = local.shape[axis]
        n = grid.shape[axis] // size
        me = mesh.get_local_rank(name)
        for boundary in BOUNDARIES:
            mode, value = parse_boundary(boundary)
            for halo_w in (2, 3 * size - 1):
                r0 = halo.EXCHANGE["rounds"]
                got = rt.exchange_halo_1axis(local, axis, halo_w, mesh, name,
                                             mode=mode, value=value)
                widths = [0] * grid.ndim
                widths[axis] = halo_w
                want = tref.pad_boundary(grid, widths, mode, value).narrow(
                    axis, me * size, size + 2 * halo_w)
                hops = -(-halo_w // size)
                rounds = 2 * (hops if mode == "periodic"
                              else min(hops, n - 1))
                ok = (torch.equal(got, want)
                      and halo.EXCHANGE["rounds"] - r0 == rounds)
                r.check(f"exchange/{mesh_shape}/{boundary}/{halo_w}", ok,
                        f"rounds {halo.EXCHANGE['rounds'] - r0} vs {rounds}")
    # a ring of one rank: every hop is a self pair (a local copy), and
    # a non-ring exchange fills zeros and sends nothing
    mesh = r.mesh((1, 8), MESH_NAMES)
    x = torch.arange(5.0, dtype=torch.float64) + 1
    copies0 = halo.EXCHANGE["self_copies"]
    got = rt.exchange_halo_1axis(x, 0, 12, mesh, "sx", mode="periodic")
    want = tref.pad_boundary(x, [12], "periodic")
    r.check("exchange/self_pairs", torch.equal(got, want)
            and halo.EXCHANGE["self_copies"] - copies0 == 6,
            halo.EXCHANGE["self_copies"] - copies0)
    sent0 = halo.EXCHANGE["bytes_sent"]
    got = rt.exchange_halo_1axis(x, 0, 7, mesh, "sx", mode="zero")
    r.check("exchange/zero_fill_past_edge",
            torch.equal(got, tref.pad_boundary(x, [7], "zero"))
            and halo.EXCHANGE["bytes_sent"] == sent0)


def suite_single(r: Rank, out_dir: str) -> None:
    """On a one-rank mesh: the plan's distributed fields and key, the
    executor, the verifier's distributed check and mutations, and the
    launch lint's prediction beside the counters."""
    import dataclasses
    torch, rt = r.torch, r.rt
    from repro_torch import analysis
    from repro_torch.analysis import launch_lint
    from repro_torch.core import plan as tplan
    from repro_torch.kernels import engine as keng
    mesh = r.mesh((1,), ("sx",))
    spec = rt.PAPER_STENCILS["jacobi1d"]
    single = tplan.lower(spec, (64,), torch.float32, backend="ref", sweeps=2,
                         device=r.device)
    dist_ = tplan.lower(spec, (64,), torch.float32, backend="ref", sweeps=2,
                        device=r.device, mesh=mesh, grid_axes=("sx",))
    s0 = tplan.PLAN_CACHE.stats()
    again = tplan.lower(spec, (64,), torch.float32, backend="ref", sweeps=2,
                        device=r.device, mesh=mesh, grid_axes=("sx",))
    s1 = tplan.PLAN_CACHE.stats()
    r.check("plan/key", dist_ is not single and again is dist_
            and s1["hits"] == s0["hits"] + 1
            and s1["lowers"] == s0["lowers"]
            and single.mesh_fingerprint is None
            and dist_.mesh_fingerprint == (("sx",), (1,), (0,), ("sx",))
            and dist_.exchange == ("zero-fill",)
            and dist_.shard_shape == (64,) and dist_.is_distributed
            and dist_.ghost_strategy == "pad" and dist_.slab_budget is None,
            (dist_.mesh_fingerprint, dist_.exchange, dist_.shard_shape))
    cuda = tplan.lower(spec, (64,), torch.float64, backend="cuda", sweeps=4,
                       device=r.device, mesh=mesh, grid_axes=("sx",))
    r.check("plan/cuda", cuda.ghost_strategy == "padded-window"
            and cuda.tile is not None and cuda.slabs is None,
            (cuda.ghost_strategy, cuda.tile))
    # the executor: one fused step of a periodic plan
    pspec = spec.with_boundary("periodic")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(48))
    p = tplan.lower(pspec, (48,), g.dtype, backend="ref", sweeps=2,
                    device=r.device, mesh=mesh, grid_axes=("sx",))
    got = tplan.execute(p, g)
    want = rt.run_iterations(pspec, g, 2)
    try:
        rt.core.halo.execute_plan(tplan.lower(pspec, (48,), g.dtype,
                                              device=r.device), g)
        refused = False
    except ValueError:
        refused = True
    r.check("plan/execute", p.exchange == ("wrap-ring",)
            and torch.equal(got, want) and refused)
    # the verifier: clean plans, then mutants
    clean = [dist_, cuda, p]
    pipe = rt.PAPER_PIPELINES["reaction_diffusion2d"]
    mesh2 = r.mesh((1, 1), MESH_NAMES)
    clean.append(tplan.lower(pipe, (32, 64), torch.float64, backend="cuda",
                             sweeps=2, device=r.device, mesh=mesh2,
                             grid_axes=("sx", "sy")))
    mixed = build_spec(("chain", "mixed"), rt)
    clean.append(tplan.lower(mixed, (32, 64), torch.float64, backend="cuda",
                             sweeps=2, device=r.device, mesh=mesh2,
                             grid_axes=("sx", None)))
    reports = [analysis.analyze_plan(c) for c in clean]
    r.check("verify/clean", all(rep.ok for rep in reports)
            and all("distributed" in rep.checks_run for rep in reports),
            [rep.pretty() for rep in reports if not rep.ok])
    per = tplan.lower(rt.PAPER_STENCILS["jacobi2d"].with_boundary(
        "periodic"), (64, 128), torch.float32, backend="cuda", sweeps=2,
        device=r.device, mesh=mesh, grid_axes=("sx", None))

    def errors(mut):
        return sorted({f.check for f in analysis.verify_plan(mut).errors})
    mutants = {
        "wrong_exchange": dataclasses.replace(per, exchange=("zero-fill",
                                                             None)),
        "shard_shape": dataclasses.replace(per, shard_shape=(32, 128)),
        "fingerprint": dataclasses.replace(
            per, mesh_fingerprint=(("sx",), (2,), (0, 1), ("sx", None))),
        "unsharded_exchange": dataclasses.replace(
            per, exchange=("wrap-ring", "wrap-ring")),
        "staged_exchange": dataclasses.replace(clean[-1],
                                               exchange=("zero-fill", None)),
        "single_with_fields": dataclasses.replace(single,
                                                  shard_shape=(64,)),
        "pad_free": dataclasses.replace(per, ghost_strategy="pad-free"),
        "budget": dataclasses.replace(per, slab_budget=1 << 30),
    }
    for name, mut in mutants.items():
        r.record["checks"][f"mutant/{name}"] = [True, errors(mut)]
    # the launch lint: the prediction beside the counters (on a CPU tensor
    # the wrappers run the plain versions, which count no launch; the
    # card's phase 2i holds the launches)
    pspec = spec.with_boundary("periodic")
    plan = tplan.lower(pspec, (64,), torch.float64, backend="cuda", sweeps=4,
                       device=r.device, mesh=mesh, grid_axes=("sx",))
    lint = analysis.lint_plan(plan)
    keng.reset_launches()
    rounds0 = rt.core.halo.EXCHANGE["rounds"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(64))
    rt.CasperEngine(pspec, backend="cuda", sweeps=4,
                    device=r.device).distributed_fn(mesh, ("sx",),
                                                    iters=10)(x)
    ran = {k: v for k, v in keng.LAUNCHES.items() if v}
    rounds = rt.core.halo.EXCHANGE["rounds"] - rounds0
    r.check("lint/prediction",
            launch_lint.predicted_launches(plan, 10) == {"K2": 3}
            and ran == ({"K2": 3} if r.device == "cuda" else {})
            and rounds == launch_lint.predicted_exchange_rounds(plan, 10)
            == 6 and lint.ok
            and any("and 2 exchange rounds per rank" in f.message
                    for f in lint.infos),
            (ran, rounds, [str(f) for f in lint.findings]))


def suite_fail(r: Rank, out_dir: str) -> None:
    """Rank 1 raises while the others wait for it in a collective."""
    import torch.distributed as dist
    if r.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


#: Phase 2i (ii) of ``chip_smoke.py``: full width, f64, mesh (4, 2);
#: key, spec, global shape, grid_axes.
CHIP_FULL = (
    ("jacobi2d_zero_8192x8192", ("stencil", "jacobi2d", "zero"),
     (8192, 8192), ("sx", "sy")),
    ("heat3d_zero_512x512x256", ("stencil", "heat3d", "zero"),
     (512, 512, 256), ("sx", "sy", None)),
    ("reaction_diffusion2d_reflect_8192x8192",
     ("pipeline", "reaction_diffusion2d"), (8192, 8192), ("sx", "sy")),
)
CHIP_ITERS, CHIP_SWEEPS = 10, 4


def shard_slices(mesh, shape, axes) -> tuple:
    """This rank's block of a ``shape`` grid, as slices."""
    from repro_torch.core import plan as tplan
    out = []
    for n, a in zip(shape, axes):
        if a is None:
            out.append(slice(None))
            continue
        size = n // tplan.mesh_axis_size(mesh, a)
        start = mesh.get_local_rank(a) * size
        out.append(slice(start, start + size))
    return tuple(out)


def suite_chip(r: Rank, out_dir: str) -> None:
    """Phase 2i of ``chip_smoke.py`` on one rank, its shards on the card:
    (i) every case of :func:`cases` in float64 on ``"cuda"`` (K2/K4) and
    ``"ref"``, the launches and rounds counted from just before the first
    run to just after the last; rank 0 then holds each gathered result
    bitwise against the single-device ``CasperEngine(...).run`` on the
    card and against ``backend="ref"``, and every rank its fused-vs-
    chained and ring rounds; (ii) each :data:`CHIP_FULL` case through
    ``CasperEngine(..., backend="cuda", sweeps=4).distributed_fn`` at
    ``iters=10``, its shard read from the parent's ``<key>_in.npy`` and
    held bitwise against the slice of its single-device run,
    ``<key>_want.npy``, with per-step records, launches, rounds and the
    peak device bytes."""
    import torch.distributed as dist
    torch, rt, halo = r.torch, r.rt, r.halo
    from repro_torch.kernels import engine as keng
    dev = torch.device(r.device)
    cuda = dev.type == "cuda"           # a CPU rehearsal runs the same steps

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    probe = r.mesh((4, 2), MESH_NAMES)
    r.record["mesh"] = "DeviceMesh('cpu'), shards on " + str(dev)
    r.record["staged_through_host"] = halo.staged_through_host(
        probe.get_group("sx"), torch.empty(1, device=dev))
    matrix = cases("float64")
    sync()
    keng.reset_launches()
    halo.reset_exchange()
    gathered = {}
    for case in matrix:
        for backend in ("cuda", "ref"):
            key = f"{case['key']}/{backend}"
            spec, mesh, g, _, _, full, rounds, launches = _run_case(
                r, case, backend, None, keng)
            pr, pl, _ = _predicted(r, spec, mesh, case, backend, None,
                                   g.dtype)
            r.record["cases"][key] = {"rounds": rounds, "launches": launches,
                                      "predicted_rounds": pr,
                                      "predicted_launches": pl}
            r.check(f"i/counts/{key}", rounds == pr and launches == pl,
                    (rounds, pr, launches, pl))
            if r.rank == 0:
                gathered[key] = full.cpu()
    sync()
    r.record["i"] = {"launches": dict(keng.LAUNCHES),
                     "rank3": dict(keng.RANK3_LAUNCHES),
                     "exchange": dict(halo.EXCHANGE)}
    cs = r.record["cases"]
    r.check("i/fused_rounds", cs["fused/t1/cuda"]["rounds"]
            >= 3 * cs["fused/t4/cuda"]["rounds"] > 0,
            (cs["fused/t1/cuda"]["rounds"], cs["fused/t4/cuda"]["rounds"]))
    r.check("i/ring_rounds", cs["ring/zero/cuda"]["rounds"]
            == cs["ring/periodic/cuda"]["rounds"] > 0)
    if r.rank == 0:
        for case in matrix:
            spec = build_spec(case["desc"], rt)
            g = torch.from_numpy(grid_for(case)).to(dev)
            single = rt.CasperEngine(spec, backend="cuda",
                                     sweeps=case["sweeps"], device=dev).run(
                                         g, iters=case["iters"]).cpu()
            ref = rt.CasperEngine(spec, backend="ref", device=dev).run(
                g, iters=case["iters"]).cpu()
            for backend in ("cuda", "ref"):
                got = gathered[f"{case['key']}/{backend}"]
                r.check(f"i/{case['key']}/{backend}",
                        torch.equal(got, single) and torch.equal(got, ref),
                        (got - single).abs().max().item())
        r.check("i/fused_equals_chained",
                torch.equal(gathered["fused/t4/cuda"],
                            gathered["fused/t1/cuda"]))
    del gathered
    full_records = {}
    for key, desc, shape, axes in CHIP_FULL:
        mesh = r.mesh((4, 2), MESH_NAMES)
        spec = build_spec(desc, rt)
        sl = shard_slices(mesh, shape, axes)
        inp = np.load(os.path.join(out_dir, f"{key}_in.npy"), mmap_mode="r")
        local = torch.from_numpy(np.ascontiguousarray(inp[sl])).to(dev)
        del inp
        fn = rt.CasperEngine(spec, backend="cuda", sweeps=CHIP_SWEEPS,
                             device=dev).distributed_fn(mesh, axes,
                                                        iters=CHIP_ITERS)
        pr, pl, plan = _predicted(
            r, spec, mesh, {"shape": shape, "sweeps": CHIP_SWEEPS,
                            "iters": CHIP_ITERS, "axes": axes},
            "cuda", None, torch.float64)
        sync()
        dist.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        keng.reset_launches()
        halo.reset_exchange()
        halo.record_steps(True)
        t0 = time.perf_counter()
        out = fn(local)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in keng.LAUNCHES.items() if v}
        rank3 = {k: v for k, v in keng.RANK3_LAUNCHES.items() if v}
        steps = halo.step_records()
        halo.record_steps(False)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        want = np.load(os.path.join(out_dir, f"{key}_want.npy"),
                       mmap_mode="r")
        equal = torch.equal(out.cpu(), torch.from_numpy(
            np.ascontiguousarray(want[sl])))
        del want
        r.check(f"ii/{key}", equal)
        r.check(f"ii/counts/{key}", launches == pl
                and halo.EXCHANGE["rounds"] == pr,
                (launches, pl, halo.EXCHANGE["rounds"], pr))
        full_records[key] = {
            "tile": plan.tile, "predicted_rounds": pr,
            "shard": list(local.shape), "wall_ms": wall, "steps": steps,
            "launches": launches, "rank3": rank3,
            "exchange": dict(halo.EXCHANGE), "peak_bytes": peak,
            "bitwise_equal_single_device": equal}
        del local, out
        if cuda:
            torch.cuda.empty_cache()
    r.record["ii"] = full_records


SUITES = {"parity": suite_parity, "single": suite_single, "fail": suite_fail,
          "chip": suite_chip}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--suite", choices=sorted(SUITES), required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
        world_size=args.world, timeout=datetime.timedelta(seconds=300))
    try:
        r = Rank(args.rank, args.world, args.device)
        SUITES[args.suite](r, args.out)
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as fh:
            json.dump(r.record, fh, default=str)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)         # a peer may wait in a collective: no teardown
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
