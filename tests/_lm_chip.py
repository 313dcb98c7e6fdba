"""The ranks of ``chip_smoke.py`` phase 2l: the sharded LM paths, eight
ranks on one GPU over gloo, at full width.

    python tests/_lm_chip.py --rank R --world N --port P --out DIR \\
        --suite chip --device cuda

``tests/_lm_world.py``'s ranks (``Rank``, ``main``) with the suite
``chip``; ``chip_smoke.py`` (``sharded_phase``) writes its single-device
references into ``DIR``, starts the ranks with
``_dist_world.run_world(..., script=SCRIPT)`` and holds their results
against the references.  The ranks import torch, numpy and
``repro_torch`` only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPT = os.path.abspath(__file__)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


lw = _load("_lm_world")
Rank, DM = lw.Rank, lw.DM

#: full width; depth cut so that the phase fits its time and the card.
CHIP = dict(serve_layers=8, rows=4, prompt=256, decode=8, max_len=272,
            train_layers=2, train_rows=4, train_seq=256, moe_layers=2,
            serve_seed=2026, train_seed=2027, moe_seed=2028, token_seed=7,
            moe_fault_expert=0)
CHIP_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=100)
COLLECTIVE_OPS = ("c10d", "gloo", "all_gather", "all_reduce",
                  "reduce_scatter", "all_to_all", "alltoall", "wait_tensor",
                  "allreduce", "allgather", "barrier", "broadcast")


def chip_cfgs():
    """(serving, training, MoE) configs of phase 2l: qwen3-14b at 8 and
    2 of its 40 layers, TP-only serving params; olmoe-1b-7b at 2 of 16."""
    from repro_torch.configs import get_config
    q = get_config("qwen3-14b")
    serve = dataclasses.replace(q, n_layers=CHIP["serve_layers"],
                                serve_params_tp_only=True)
    train = dataclasses.replace(q, n_layers=CHIP["train_layers"])
    moe = dataclasses.replace(get_config("olmoe-1b-7b"),
                              n_layers=CHIP["moe_layers"])
    return serve, train, moe


def chip_tokens(vocab: int, rows: int, n: int, salt: int = 0):
    rng = np.random.default_rng(CHIP["token_seed"] + salt)
    return rng.integers(0, vocab, (rows, n)).astype(np.int64)


def _sync(r):
    if r.device.type == "cuda":
        r.torch.cuda.synchronize()
    r.torch.distributed.barrier()


def _reset_peak(r):
    if r.device.type == "cuda":
        r.torch.cuda.reset_peak_memory_stats()


def _peak_gib(r) -> float:
    if r.device.type != "cuda":
        return 0.0
    return r.torch.cuda.max_memory_allocated() / 2**30


def _free(r):
    if r.device.type == "cuda":
        r.torch.cuda.empty_cache()


def _collective_share(prof, wall_s: float) -> float:
    """The share of ``wall_s`` that the host spent inside collectives:
    the union of the profiler's CPU events whose names name one."""
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events()
                if any(k in e.name.lower() for k in COLLECTIVE_OPS))
    total, cur = 0.0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e6 / wall_s          # profiler times are in us


def _timed(r, fn, profile: bool = False):
    """(result, wall seconds, collective share or None) of ``fn()``
    between two synchronising barriers."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    _sync(r)
    t0 = time.perf_counter()
    if profile:
        with prof_ctx(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
            _sync(r)
    else:
        out = fn()
        _sync(r)
    dt = time.perf_counter() - t0
    return out, dt, (_collective_share(prof, dt) if profile else None)


def fingerprint(t, chunk: int = 1 << 22) -> int:
    """A position-weighted sum of the bits of DTensor ``t`` over its
    mesh (a collective of the world, which the mesh spans; one replica
    of each block counts), in chunks of the local block: equal for two
    layouts of the same values."""
    import torch
    import torch.distributed as dist
    from repro_torch.sharding import block_ranges
    local = t.to_local().contiguous()
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    acc = torch.zeros((), dtype=torch.long, device=local.device)
    first = all(c == 0 for j, c in enumerate(coord)
                if not hasattr(t.placements[j], "dim"))
    if first and local.numel():
        bits = local.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                           8: torch.int64}[local.element_size()]).reshape(-1)
        rg = block_ranges(t.shape, mesh, t.placements, coord)
        lshape = [b - a for a, b in rg] or [1]
        starts = [a for a, _ in rg] or [0]
        gshape = list(t.shape) or [1]
        for at in range(0, bits.numel(), chunk):
            k = torch.arange(at, min(at + chunk, bits.numel()),
                             device=local.device)
            idx = torch.zeros_like(k)
            rest = k
            for d in reversed(range(len(lshape))):
                m = rest % lshape[d]
                rest = rest // lshape[d]
                stride = math.prod(gshape[d + 1:])
                idx += (starts[d] + m) * stride
            w = (idx * 2654435761 + 97) % 2147483647
            acc += (bits[at:at + k.numel()].long() * w).sum()
    acc = acc.reshape(1).cpu()
    dist.all_reduce(acc)
    return int(acc.item())


def bf16_bits(t) -> np.ndarray:
    """A tensor rounded to bfloat16, as the int16 numpy array of its bits
    (numpy has no bfloat16)."""
    import torch
    return t.detach().to(torch.bfloat16).cpu().view(torch.int16).numpy()


def from_bf16_bits(a, device):
    """The float32 tensor of :func:`bf16_bits`' array."""
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).view(
        torch.bfloat16).to(device).float()


#: per leaf of a step, what :func:`step_sums` adds up (over the ranks'
#: blocks) and what it takes the largest of
SUM_KEYS = ("delta_diff", "delta_flipped", "delta_ref", "m_diff", "m_ref")
MAX_KEYS = ("delta_diff_max", "delta_ref_max", "m_diff_max", "m_ref_max")


def step_sums(delta, ref_delta, m, ref_m):
    """(sums, maxes) of one block of a leaf: the squared gaps of the
    master's change ``delta`` and of the first moment ``m`` from the
    reference's, the squared gap of the change with its sign flipped (a
    planted fault: the update added, not subtracted), the reference's
    squares, and the largest entries of the gaps and of the reference."""
    import torch
    dd, dm = delta - ref_delta, m - ref_m
    sums = torch.stack([dd.square().sum(), (delta + ref_delta).square().sum(),
                        ref_delta.square().sum(), dm.square().sum(),
                        ref_m.square().sum()]).double()
    if not dd.numel():
        return sums, torch.zeros(len(MAX_KEYS), dtype=torch.float64,
                                 device=sums.device)
    maxes = torch.stack([dd.abs().max(), ref_delta.abs().max(),
                         dm.abs().max(), ref_m.abs().max()]).double()
    return sums, maxes


def step_gaps(sums, maxes) -> dict:
    """Per leaf, from :func:`step_sums`' totals: the master's change and
    the first moment against the reference's, as the gap's norm over the
    reference's (``*_rel``) and as the largest gap over the reference's
    largest entry (``*_max_rel``); ``flipped_rel`` reads the planted
    sign flip."""
    s = dict(zip(SUM_KEYS, sums))
    m = dict(zip(MAX_KEYS, maxes))

    def ratio(a, b):
        return math.sqrt(a / b) if b > 0 else 0.0
    return {"delta_rel": ratio(s["delta_diff"], s["delta_ref"]),
            "flipped_rel": ratio(s["delta_flipped"], s["delta_ref"]),
            "m_rel": ratio(s["m_diff"], s["m_ref"]),
            "delta_max_rel": (m["delta_diff_max"] / m["delta_ref_max"]
                              if m["delta_ref_max"] > 0 else 0.0),
            "m_max_rel": (m["m_diff_max"] / m["m_ref_max"]
                          if m["m_ref_max"] > 0 else 0.0)}


def step_sums_on_mesh(r: Rank, params, state, init, ref_dir) -> list:
    """:func:`step_gaps` per leaf of a step on a mesh: each rank reads its
    block of the reference's change and first moment (``ref_dir/d<i>.npy``,
    ``m<i>.npy``: bfloat16 bits of whole leaves) and holds its blocks of
    the master's change (the master less ``init``, its params' blocks
    before the step) and of m against them; the sums are added and the
    maxima taken over the world (a replicated block counts once per
    replica in both the gap and the reference, so their ratio holds)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import block_ranges
    out = []
    for i, (p0, ma, m) in enumerate(zip(
            init, tree_leaves(state["master"], torch.is_tensor),
            tree_leaves(state["m"], torch.is_tensor))):
        rg = block_ranges(ma.shape, ma.device_mesh, ma.placements,
                          ma.device_mesh.get_coordinate())
        sl = tuple(slice(a, b) for a, b in rg)
        ref = [from_bf16_bits(np.load(os.path.join(ref_dir, f"{k}{i}.npy"),
                                      mmap_mode="r")[sl], r.device)
               for k in ("d", "m")]
        got = ma.to_local().float() - p0.float()
        sums, maxes = step_sums(got, ref[0], m.to_local(), ref[1])
        del ref, got
        sums, maxes = sums.cpu(), maxes.cpu()
        dist.all_reduce(sums)
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX)
        out.append(step_gaps(sums.tolist(), maxes.tolist()))
    return out


def chip_serving(r: Rank, mesh, rec) -> None:
    """(i): the 8-layer qwen3-14b, TP-only params, prefill of 4 x 256 then
    8 teacher-forced decode steps, with ``decode_kv_seq_shard`` off and
    on; then the last step again one cache slot late (a planted fault).
    Every logit is written for the parent to hold against the
    single-device run."""
    from repro_torch.models import make_arch
    from repro_torch.models.common import init_params, scale_scores
    from repro_torch.sharding import ShardCtx, full_tensor
    torch = r.torch
    cfg, _, _ = chip_cfgs()
    ov = {"fsdp": None}
    arch = make_arch(cfg)
    specs = arch.param_specs(cfg)
    _reset_peak(r)
    params, init_s, _ = _timed(r, lambda: init_params(
        torch.Generator(r.device).manual_seed(CHIP["serve_seed"]), specs,
        r.device, mesh=mesh, overrides=ov))
    scale_scores(params, specs)
    toks = torch.from_numpy(chip_tokens(cfg.vocab, CHIP["rows"],
                                        CHIP["prompt"] + CHIP["decode"]))
    toks = toks.to(r.device)
    p = CHIP["prompt"]
    out = {"init_s": init_s}
    for flash in (False, True):
        c = dataclasses.replace(cfg, decode_kv_seq_shard=flash)
        a = make_arch(c)
        ctx = ShardCtx(mesh, overrides=ov)
        logits = []
        with torch.no_grad():
            prompt = {"tokens": ctx.place(toks[:, :p], "dp", None)}
            (st, n, lg), pre_s, _ = _timed(r, lambda: a.prefill(
                params, prompt, c, ctx, max_len=CHIP["max_len"]))
            logits.append(full_tensor(lg)[:, -1].float().cpu())
            steps, shares = [], []
            for i in range(CHIP["decode"]):
                tok = ctx.place(toks[:, p + i:p + i + 1], "dp", None)
                (st, n_next, lg), dt, share = _timed(
                    r, lambda: a.decode(params, st, n, tok, c, ctx),
                    profile=(i == CHIP["decode"] - 2))
                logits.append(full_tensor(lg)[:, -1].float().cpu())
                steps.append(dt * 1e3)
                if share is not None:
                    shares.append(share)
                last = (tok, n)
                n = n_next
            tok, n_last = last
            _, _, lg = a.decode(params, st, n_last + 1, tok, c, ctx)
            fault = full_tensor(lg)[:, -1].float().cpu()
        name = "flash" if flash else "dense"
        out[name] = {"prefill_ms": pre_s * 1e3, "decode_ms": steps,
                     "decode_collective_share": shares[0]}
        if r.rank == 0:
            np.save(os.path.join(r.out, f"serve_{name}.npy"),
                    torch.stack(logits, 1).numpy())
            np.save(os.path.join(r.out, f"serve_{name}_fault.npy"),
                    fault.numpy())
    out["peak_gib"] = _peak_gib(r)
    rec["serving"] = out
    del params
    _free(r)


def chip_training(r: Rank, m24, m42, m81, rec) -> None:
    """(ii): the 2-layer qwen3-14b, FSDP + TP on (2, 4), one AdamW step
    (float32 moments: the 8-bit ones gather a leaf's sharded last dim for
    the update, past the card's memory with eight ranks).  Every rank
    holds its blocks of the f32 master's change and of the first moment
    against the parent's single-device step (read from its files:
    ``step_sums_on_mesh``), and its params against the master they were
    written back from (bitwise).  The params are saved as a
    checkpoint on (2, 4) and restored on (4, 2) and on (8, 1) (each
    leaf's fingerprint equal to the saved one's); the optimizer state is
    re-meshed live onto (8, 1) beside them, the whole state re-meshed
    onto (2, 4) (fingerprints again), and a second step taken there.
    The whole 31 GB state through a checkpoint would take about 400 s
    of disk on the card's host (a first run: 100 s to save, 140-155 s a
    restore), so the checkpoint holds the params (4.4 GB); the CPU
    tests restore a whole training state on another mesh."""
    import torch.distributed as dist
    from repro_torch.checkpointing import restore_checkpoint, save_checkpoint
    from repro_torch.models import make_arch
    from repro_torch.models.common import (init_params, param_shardings,
                                           tree_leaves, tree_map)
    from repro_torch.optim import AdamWConfig, init_opt_state, opt_state_specs
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import remesh_tree
    torch = r.torch
    _, cfg, _ = chip_cfgs()
    arch = make_arch(cfg)
    specs = arch.param_specs(cfg)
    opt = AdamWConfig(**CHIP_OPT)
    _reset_peak(r)
    params = init_params(torch.Generator(r.device).manual_seed(
        CHIP["train_seed"]), specs, r.device, mesh=m24)
    state = init_opt_state(params, opt)
    step = make_train_step(arch, opt, ShardCtx(m24))
    init = [t.to_local().clone() for t in tree_leaves(params,
                                                      torch.is_tensor)]
    batches = [{"tokens": torch.from_numpy(chip_tokens(
        cfg.vocab, CHIP["train_rows"], CHIP["train_seq"], salt=k)).to(
        r.device)} for k in (1, 2)]
    (params, state, met), step_s, share = _timed(
        r, lambda: step(params, state, batches[0]), profile=True)
    out = {"loss1": float(met["loss"]), "step_ms": step_s * 1e3,
           "step_collective_share": share}
    # this rank's blocks of the step against the parent's single-device
    # step: the f32 master's change and the first moment, and the params
    # written back from the master
    out["step_gaps"] = step_sums_on_mesh(r, params, state, init,
                                         os.path.join(r.out, "train"))
    del init
    wrote = torch.tensor([float(all(
        torch.equal(p.to_local(), ma.to_local().to(p.dtype))
        for p, ma in zip(tree_leaves(params, torch.is_tensor),
                         tree_leaves(state["master"], torch.is_tensor))))])
    dist.all_reduce(wrote, op=dist.ReduceOp.MIN)
    r.check("2l params written back from the master", bool(wrote.item()))
    out["state_bytes"] = sum(t.numel() * t.element_size() for t in
                             tree_leaves({"p": params, "o": state},
                                         torch.is_tensor))
    ospecs = opt_state_specs(specs, opt)
    prints = [fingerprint(t) for t in tree_leaves(params, torch.is_tensor)]
    oprints = [fingerprint(t) if hasattr(t, "device_mesh") else None
               for t in tree_leaves(state, torch.is_tensor)]
    ckpt = os.path.join(r.out, "ckpt")
    _, dt, _ = _timed(r, lambda: save_checkpoint(ckpt, 1, params))
    out["save_s"] = dt
    out["ckpt_bytes"] = sum(t.numel() * t.element_size()
                            for t in tree_leaves(params, torch.is_tensor))
    # restore reads shapes and dtypes only: the (2, 4) params are freed
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params,
                    torch.is_tensor)
    del params
    restored = None
    for name, mesh in (("4x2", m42), ("8x1", m81)):
        restored = None                 # the (4, 2) params freed first
        _free(r)
        sh = param_shardings(specs, mesh)
        got, dt, _ = _timed(r, lambda: restore_checkpoint(ckpt, 1, like,
                                                          shardings=sh))
        leaves = list(tree_leaves(got, torch.is_tensor))
        out[f"restore_{name}_s"] = dt
        r.check(f"2l restore on {name} bitwise", all(
            fingerprint(t) == p for t, p in zip(leaves, prints)))
        r.check(f"2l restore on {name} placed", all(
            t.device_mesh is mesh for t in leaves))
        restored = got                  # the (8, 1) params are kept
        del got, leaves
    # the optimizer state re-meshed live beside them, then all onto (2, 4)
    state81, dt, _ = _timed(r, lambda: remesh_tree(state, ospecs, m81))
    out["remesh_opt_s"] = dt
    del state
    tree = {"opt": state81, "params": restored}
    tspecs = {"opt": ospecs, "params": specs}
    moved, dt, _ = _timed(r, lambda: {k: remesh_tree(tree[k], tspecs[k], m24)
                                      for k in tree})
    out["remesh_s"] = dt
    r.check("2l remesh bitwise", all(
        p is None or fingerprint(t) == p for t, p in zip(
            tree_leaves(moved, torch.is_tensor), oprints + prints)))
    del tree, state81, restored
    (_, _, met2), dt, _ = _timed(r, lambda: step(
        moved["params"], moved["opt"], batches[1]))
    out["loss2"] = float(met2["loss"])
    out["step2_ms"] = dt * 1e3
    out["peak_gib"] = _peak_gib(r)
    rec["training"] = out
    del moved
    _free(r)


def drop_expert(params, e: int) -> None:
    """A planted fault: expert ``e``'s output dropped in every layer (its
    ``w_down`` rows zeroed, in the blocks that hold them)."""
    from repro_torch.sharding import block_ranges, is_dtensor
    w = params["units"]["ffn_0"]["w_down"]          # (layers, e, f, d)
    if not is_dtensor(w):
        w[:, e].zero_()
        return
    a, b = block_ranges(w.shape, w.device_mesh, w.placements,
                        w.device_mesh.get_coordinate())[1]
    if a <= e < b:
        w.to_local()[:, e - a].zero_()


def moe_layer_input(cfg) -> np.ndarray:
    """The seeded input of the MoE layer check: (rows, prompt, d_model)
    standard normal draws (an RMS-normed hidden state's scale), float32
    (rounded to bfloat16 on use)."""
    rng = np.random.default_rng(CHIP["token_seed"] + 4)
    return rng.standard_normal((CHIP["rows"], CHIP["prompt"],
                                cfg.d_model)).astype(np.float32)


def moe_layer(params, x, cfg, ctx):
    """Layer 0's MoE block of ``params`` on ``x`` (B, S, D), its output
    whole in every rank (on a mesh: the unit's weights gathered as the
    model gathers them, ``x`` placed over ``dp``)."""
    import torch
    from repro_torch.models.common import tree_map
    from repro_torch.models.moe import moe_ffn
    from repro_torch.sharding import full_tensor, on_mesh
    up = tree_map(lambda t: t[0], params["units"], torch.is_tensor)
    with torch.no_grad(), on_mesh():
        up = ctx.gather_weights(up)
        y, _ = moe_ffn(up["ffn_0"], ctx.place(x, "dp", None, None),
                       cfg.moe, ctx)
        return full_tensor(y)


def chip_moe(r: Rank, mesh, rec) -> None:
    """(iii): the 2-layer olmoe-1b-7b, prefill of 4 x 256 with
    ``dispatch="ep"`` and ``"local"`` (the last position's logits written
    for the parent), then layer 0's MoE block alone on a seeded input
    with both dispatches and, as a planted fault, with one expert's
    output dropped (its whole output written, bfloat16 bits): the logits
    of a 2-layer model at this init do not see one expert dropped (they
    read the clean gap, one bfloat16 ulp)."""
    from repro_torch.models import make_arch
    from repro_torch.models.common import init_params
    from repro_torch.sharding import ShardCtx, full_tensor
    torch = r.torch
    _, _, cfg = chip_cfgs()
    specs = make_arch(cfg).param_specs(cfg)
    params = init_params(torch.Generator(r.device).manual_seed(
        CHIP["moe_seed"]), specs, r.device, mesh=mesh)
    toks = torch.from_numpy(chip_tokens(cfg.vocab, CHIP["rows"],
                                        CHIP["prompt"], salt=3)).to(r.device)
    x = torch.from_numpy(moe_layer_input(cfg)).to(r.device, torch.bfloat16)
    out = {}
    cfgs = {d: dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=d)) for d in ("ep", "local")}
    ctx = ShardCtx(mesh)
    for dispatch, c in cfgs.items():
        a = make_arch(c)
        with torch.no_grad():
            batch = {"tokens": ctx.place(toks, "dp", None)}
            (_, _, lg), dt, share = _timed(r, lambda: a.prefill(
                params, batch, c, ctx, max_len=CHIP["prompt"]),
                profile=True)
            lg = full_tensor(lg)[:, -1].float().cpu()
        out[dispatch] = {"prefill_ms": dt * 1e3, "collective_share": share}
        if r.rank == 0:
            np.save(os.path.join(r.out, f"moe_{dispatch}.npy"), lg.numpy())
    for name in ("ep", "local", "fault"):
        if name == "fault":
            drop_expert(params, CHIP["moe_fault_expert"])
        y = moe_layer(params, x, cfgs["local" if name == "local" else "ep"],
                      ctx)
        if r.rank == 0:
            np.save(os.path.join(r.out, f"moe_layer_{name}.npy"),
                    bf16_bits(y))
        del y
    rec["moe"] = out
    del params
    _free(r)


def suite_chip(r: Rank) -> None:
    from repro_torch.kernels import engine as keng
    m24, m42, m81 = (r.mesh(s, DM) for s in ((2, 4), (4, 2), (8, 1)))
    before = dict(keng.LAUNCHES)
    rec = r.record["chip"] = {"mesh": [2, 4]}
    t0 = time.perf_counter()
    chip_serving(r, m24, rec)
    rec["serving_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chip_training(r, m24, m42, m81, rec)
    rec["training_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chip_moe(r, m24, rec)
    rec["moe_s"] = time.perf_counter() - t0
    rec["launches"] = {k: keng.LAUNCHES[k] - before[k]
                       for k in keng.LAUNCHES}
    r.check("2l launches none of K1-K5", not any(rec["launches"].values()),
            rec["launches"])


if __name__ == "__main__":
    lw.SUITES["chip"] = suite_chip
    sys.exit(lw.main())
