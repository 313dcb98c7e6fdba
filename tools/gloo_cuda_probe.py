"""Which collectives a gloo group carries for CUDA tensors, on the card.

The sharded LM paths (``repro_torch.sharding``) run DTensors on a
``"cuda"`` ``DeviceMesh`` whose groups are gloo's (NCCL refuses two ranks
on one GPU), so every collective that a redistribution issues reaches
gloo with CUDA tensors.  This script tries each one in a world of its
own (a collective that gloo lacks may abort its process):

    python3 tools/gloo_cuda_probe.py [--ranks 2] [--only A,B] [--out FILE]

Each case spawns ``--ranks`` processes joined over gloo
(``tcp://127.0.0.1:<port>``), all on ``cuda:0`` (``--device cpu`` rehearses it on the host), runs one collective
(or one DTensor redistribution) on CUDA tensors, checks the values, and
reports ``ok``, ``wrong`` or the error.  The ``routed_`` cases repeat a
DTensor case after ``repro_torch.sharding.route_gloo_gathers``; the
``rate_`` cases time 64 MiB collectives (GB/s of each rank's input).  It prints one JSON object as
its last line (and writes it to ``--out``), with the torch and CUDA
versions and the card's name.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import traceback

CASES = ("all_reduce_sum", "all_reduce_max", "broadcast", "all_gather",
         "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single", "dtensor_shard_to_replicate",
         "dtensor_partial_to_replicate", "dtensor_partial_to_shard",
         "dtensor_shard0_to_shard1", "dtensor_from_local_matmul",
         "funcol_all_gather", "dtensor_from_local_to_replicate",
         "dtensor_full_tensor_2d", "routed_shard_to_replicate",
         "routed_full_tensor_2d", "rate_all_reduce", "rate_all_gather")


def _case(name: str, rank: int, world: int, device: str):
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    t = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
    if name == "all_reduce_sum":
        dist.all_reduce(t)
        want = sum(torch.arange(4 * world, dtype=torch.float32) + r
                   for r in range(world))
        return t.cpu(), want
    if name == "all_reduce_max":
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.cpu(), torch.arange(4 * world, dtype=torch.float32) + world - 1
    if name == "broadcast":
        dist.broadcast(t, 0)
        return t.cpu(), torch.arange(4 * world, dtype=torch.float32)
    if name == "all_gather":
        outs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(outs, t)
        return torch.cat([o.cpu() for o in outs]), torch.cat(
            [torch.arange(4 * world, dtype=torch.float32) + r
             for r in range(world)])
    if name == "all_gather_into_tensor":
        out = torch.empty(world * t.numel(), device=dev)
        dist.all_gather_into_tensor(out, t)
        return out.cpu(), torch.cat(
            [torch.arange(4 * world, dtype=torch.float32) + r
             for r in range(world)])
    if name == "reduce_scatter_tensor":
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, t)
        full = sum(torch.arange(4 * world, dtype=torch.float32) + r
                   for r in range(world))
        return out.cpu(), full[4 * rank:4 * rank + 4]
    if name == "all_to_all_single":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        want = torch.cat([(torch.arange(4 * world, dtype=torch.float32)
                           + r)[4 * rank:4 * rank + 4] for r in range(world)])
        return out.cpu(), want
    if name.startswith("rate_"):
        # 64 MiB of f32 per rank, 5 timed rounds after one warm-up
        x = torch.ones(1 << 24, device=dev)
        out = torch.empty(world << 24, device=dev)
        import time

        def one():
            if name == "rate_all_reduce":
                dist.all_reduce(x)
            else:
                dist.all_gather_into_tensor(out, x)
        one()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            one()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        _RATE["GB/s"] = 5 * x.numel() * 4 / (time.perf_counter() - t0) / 1e9
        return torch.zeros(1), torch.zeros(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    if name.startswith("routed_"):
        # the port's route for DTensor's all-gathers on a gloo group
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src"))
        from repro_torch.sharding import route_gloo_gathers
        route_gloo_gathers(dev.type)
        name = name.replace("routed_", "dtensor_")
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("model",))
    g = torch.Generator().manual_seed(0)
    full = torch.randn(4 * world, 2 * world, generator=g)
    if name == "dtensor_shard_to_replicate":
        d = distribute_tensor(full.to(dev), mesh, [Shard(0)],
                              src_data_rank=None)
        return d.redistribute(mesh, [Replicate()]).to_local().cpu(), full
    if name in ("dtensor_partial_to_replicate", "dtensor_partial_to_shard"):
        d = DTensor.from_local(full.to(dev) * (rank + 1), mesh, [Partial()])
        want = full * sum(range(1, world + 1))
        if name.endswith("replicate"):
            return d.redistribute(mesh, [Replicate()]).to_local().cpu(), want
        return (d.redistribute(mesh, [Shard(0)]).to_local().cpu(),
                want.chunk(world)[rank])
    if name == "dtensor_shard0_to_shard1":
        d = distribute_tensor(full.to(dev), mesh, [Shard(0)],
                              src_data_rank=None)
        return (d.redistribute(mesh, [Shard(1)]).to_local().cpu(),
                full.chunk(world, dim=1)[rank])
    if name == "dtensor_from_local_matmul":
        w = torch.randn(2 * world, 3, generator=g)
        a = distribute_tensor(full.to(dev), mesh, [Shard(1)],
                              src_data_rank=None)
        b = distribute_tensor(w.to(dev), mesh, [Shard(0)],
                              src_data_rank=None)
        return (a @ b).full_tensor().cpu(), full @ w
    if name == "funcol_all_gather":
        import torch.distributed._functional_collectives as funcol
        d = full.to(dev).chunk(world)[rank].contiguous()
        got = funcol.all_gather_tensor(d, 0, (mesh, 0))
        return funcol.wait_tensor(got).cpu(), full
    if name == "dtensor_from_local_to_replicate":
        d = DTensor.from_local(full.to(dev).chunk(world)[rank].contiguous(),
                               mesh, [Shard(0)])
        return d.redistribute(mesh, [Replicate()]).to_local().cpu(), full
    if name == "dtensor_full_tensor_2d":
        m2 = init_device_mesh(dev.type, (world // 2 or 1, 2 if world > 1
                                         else 1),
                              mesh_dim_names=("data", "model"))
        d = distribute_tensor(full.to(dev), m2, [Shard(0), Shard(1)],
                              src_data_rank=None)
        return d.full_tensor().cpu(), full
    raise KeyError(name)


_RATE: dict = {}


def _worker(name: str, rank: int, world: int, port: int, out: str,
            device: str) -> None:
    import faulthandler
    import torch
    import torch.distributed as dist
    faulthandler.enable()            # a crash prints its Python stack
    rec = {"case": name, "rank": rank}
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        got, want = _case(name, rank, world, device)
        err = float((got.float() - want.float()).abs().max())
        rec.update(status="ok" if err <= 1e-5 else "wrong", err=err, **_RATE)
        dist.destroy_process_group()
    except Exception as e:           # noqa: BLE001 - reported, not raised
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:400],
                   trace=traceback.format_exc()[-800:])
    with open(out, "w") as f:
        json.dump(rec, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=90.0)
    ap.add_argument("--device", default="cuda:0",
                    help="cpu rehearses the probe without a card")
    ap.add_argument("--only", default=None,
                    help="comma-separated cases (default: all)")
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("CASE", "RANK", "PORT", "OUT"))
    args = ap.parse_args()
    if args.worker:
        name, rank, port, out = args.worker
        _worker(name, int(rank), args.ranks, int(port), out, args.device)
        return 0
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "build", "gloo_probe")
    os.makedirs(tmp, exist_ok=True)
    results = {}
    for name in (args.only.split(",") if args.only else CASES):
        port = _free_port()
        outs = [os.path.join(tmp, f"{name}.{r}.json")
                for r in range(args.ranks)]
        for o in outs:
            if os.path.exists(o):
                os.remove(o)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ranks",
             str(args.ranks), "--device", args.device, "--worker", name, str(r), str(port), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(args.ranks)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=args.timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
        recs = []
        for r, o in enumerate(outs):
            if os.path.exists(o):
                with open(o) as f:
                    recs.append(json.load(f))
            else:
                recs.append({"rank": r, "status": "died",
                             "rc": procs[r].returncode,
                             "log": logs[r].decode(errors="replace")[-3000:]})
        status = ("ok" if all(x["status"] == "ok" for x in recs)
                  else next(x["status"] for x in recs if x["status"] != "ok"))
        results[name] = {"status": status, "ranks": recs}
        print(f"{name}: {status}", flush=True)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": (torch.cuda.get_device_name(0)
                         if args.device.startswith("cuda") else "cpu"),
              "ranks": args.ranks,
              "status": {k: v["status"] for k, v in results.items()},
              "detail": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report["status"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
