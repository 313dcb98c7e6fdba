"""Worlds of local ranks for the sharded LM paths.

    python tests/_lm_world.py --rank R --world N --port P --out DIR \\
        --suite lm|families|train|recurrent|ce [--device cpu|cuda]

One process per rank, joined over gloo, as ``tests/_dist_world.py``
starts them (``run_world(..., script=SCRIPT)``).  The ranks import torch,
numpy and ``repro_torch`` only.  The parent writes the reference's
parameters (``write_params``: the reduced config's init as float32
arrays, which hold the bfloat16 values exactly) into ``DIR``; each case
builds its mesh, carries them onto it (``params_from_reference`` with
``mesh=``), runs, and the mesh's first rank writes ``DIR/<case>.npz``
with the gathered results.  Every rank writes ``DIR/rank<R>.json``
(its checks and times).

Suites:

* ``lm`` (8 ranks): yi-9b, one train step and serving (prefill, then
  teacher-forced decode steps) on (2, 2) and (4, 1) in ranks 0-3 while
  ranks 4-7 run (1, 4) (and flash-decode against dense there), then
  both on the (2, 2, 2) pod mesh;
* ``families`` (4 ranks, (2, 2)): olmoe with ``dispatch="ep"`` and
  ``"local"``, and zamba2, xLSTM, Whisper and qwen2-moe, a prefill and
  one decode step each;
* ``recurrent`` (8 ranks): one float32 step each of Whisper and xLSTM
  on (2, 2), and xLSTM's on (1, 8) with its rows split over both mesh
  dims, the moments written for the reference's single-device step;
* ``ce`` (4 ranks): the vocabulary-parallel cross entropy on (2, 2) and
  (1, 4), its loss and its grad;
* ``train`` (4 ranks): a step with 8-bit AdamW state and compression on
  (2, 2), the seeded init on the mesh against one device, a sharded
  checkpoint for the reference to restore, a ``Trainer`` saving on
  (2, 2), resumed on (4, 1) and re-meshed, and ``ServeEngine(mesh=)``
  beside the engine on one device, and four float32 ``Trainer`` steps
  on (2, 2) beside one device's.

``tests/_lm_chip.py`` adds the suite of ``chip_smoke.py`` phase 2l.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPT = os.path.abspath(__file__)

TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)
TRAIN_ROWS, TRAIN_SEQ, TRAIN_SEED = 4, 32, 3
SERVE_ROWS, SERVE_SEQ, SERVE_SEED = 4, 12, 5
DECODE_STEPS = 2
MAX_LEN = 16
FRAMES = 16                     # Whisper's audio frames per clip


def inputs(cfg, b: int, s: int, seed: int) -> dict:
    """Seeded numpy inputs (tokens; Whisper's frames), the draws of
    ``tests/_lm_reference.inputs``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_patches:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def keypaths(tree, prefix=""):
    """(keystr path, leaf) pairs in sorted key order (jax's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keypaths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from keypaths(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def write_params(path: str, tree) -> None:
    """A numpy tree (the reference's params) as float32 arrays by path;
    0-d leaves kept 0-d."""
    np.savez(path, **{k: np.asarray(v, np.float32)
                      for k, v in keypaths(tree)})


def read_params(path: str, like):
    """The tree of ``like``'s structure from :func:`write_params`'s file
    (numpy float32 leaves)."""
    data = np.load(path)
    flat = {k: data[k] for k in data.files}

    def build(t, prefix=""):
        if isinstance(t, dict):
            return {k: build(t[k], f"{prefix}[{k!r}]") for k in sorted(t)}
        if isinstance(t, tuple):
            return tuple(build(x, f"{prefix}[{i}]") for i, x in enumerate(t))
        return flat[prefix]
    return build(like)


def change_gap(want, got, init) -> float:
    """|got - want| over |want - init| in norm: a float32 param's change
    from ``init`` after one step against the reference's."""
    init = np.asarray(init, np.float64)
    want = np.asarray(want, np.float64)
    gap = np.asarray(got, np.float64) - want
    return float(np.sqrt((gap ** 2).sum() / ((want - init) ** 2).sum()))


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
class Rank:
    def __init__(self, rank: int, world: int, device: str, out: str):
        import torch
        self.torch = torch
        self.rank, self.world, self.out = rank, world, out
        self.device = torch.device(device)
        self.record = {"rank": rank, "checks": {}, "seconds": {}}

    def mesh(self, shape, names, first: int = 0):
        """A mesh over ranks ``first`` .. ``first + prod(shape) - 1``;
        every rank builds every mesh, in the same order."""
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.sharding import route_gloo_gathers
        if self.device.type == "cuda":
            route_gloo_gathers("cuda")
        n = int(np.prod(shape))
        ranks = self.torch.arange(first, first + n).reshape(shape)
        return DeviceMesh(self.device.type, ranks, mesh_dim_names=names)

    def check(self, name, ok, detail=""):
        self.record["checks"][name] = [bool(ok), str(detail)]

    def write(self, mesh, name: str, arrays: dict) -> None:
        """``arrays`` (gathered, on every rank of ``mesh``) saved by the
        mesh's first rank."""
        if all(c == 0 for c in mesh.get_coordinate()):
            np.savez(os.path.join(self.out, name.replace("/", "__")),
                     **arrays)


def _arch(name: str, **changes):
    from repro_torch.configs import get_config
    from repro_torch.models import make_arch
    cfg = get_config(name, reduced=True)
    moe = changes.pop("moe", None)
    if moe:
        changes["moe"] = dataclasses.replace(cfg.moe, **moe)
    cfg = dataclasses.replace(cfg, **changes)
    return cfg, make_arch(cfg)


def _np(t) -> np.ndarray:
    from repro_torch.sharding import full_tensor
    return full_tensor(t).detach().float().cpu().numpy()


def _params(r: Rank, name: str, cfg, arch, dtype, mesh, overrides=None):
    from repro_torch import params_from_reference
    specs = arch.param_specs(cfg)
    tree = read_params(os.path.join(r.out, f"params_{name}.npz"), specs)
    return params_from_reference(tree, device=r.device, dtype=dtype,
                                 mesh=mesh, specs=specs, overrides=overrides)


def _batch(r: Rank, cfg, b, s, seed, dtype):
    torch = r.torch
    return {k: (torch.from_numpy(v).to(dtype) if v.dtype.kind == "f"
                else torch.from_numpy(v)).to(r.device)
            for k, v in inputs(cfg, b, s, seed).items()}


def train_case(r: Rank, mesh, key: str, arch_name: str, dtype: str,
               **opt_kw):
    """One train step from the reference's params; writes the loss, the
    grad norm, the updated params and the first moments, whole."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim import compress as gcomp
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    torch = r.torch
    t0 = time.perf_counter()
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    cfg, arch = _arch(arch_name)
    params = _params(r, arch_name, cfg, arch, tdt, mesh)
    compression = opt_kw.pop("compression", False)
    opt = AdamWConfig(**TRAIN_OPT, **opt_kw)
    state = init_opt_state(params, opt)
    step = make_train_step(arch, opt, ShardCtx(mesh), compression)
    batch = _batch(r, cfg, TRAIN_ROWS, TRAIN_SEQ, TRAIN_SEED, tdt)
    args = [gcomp.init_error(params)] if compression else []
    out = step(params, state, batch, *args)
    params, state, met = out[0], out[1], out[2]
    arrays = {"loss": np.asarray(float(met["loss"])),
              "grad_norm": np.asarray(float(met["grad_norm"]))}
    for (path, _), t in zip(keypaths(params),
                            tree_leaves(params, torch.is_tensor)):
        arrays["params" + path] = _np(t)
    if not opt.quantize_state:
        for (path, _), t in zip(keypaths(state["m"]),
                                tree_leaves(state["m"], torch.is_tensor)):
            arrays["m" + path] = _np(t)
    if compression:
        arrays["err_norm"] = np.asarray(float(sum(
            (_np(e) ** 2).sum() for e in tree_leaves(out[3],
                                                      torch.is_tensor))))
    r.write(mesh, key, arrays)
    r.record["seconds"][key] = time.perf_counter() - t0


def serve_case(r: Rank, mesh, key: str, arch_name: str, dtype: str,
               f32_cache: bool = False, overrides=None,
               decode_steps: int = DECODE_STEPS, **changes):
    """Prefill over ``SERVE_SEQ`` tokens, then ``DECODE_STEPS``
    teacher-forced decode steps; writes every step's logits, whole."""
    from repro_torch.sharding import ShardCtx
    torch = r.torch
    t0 = time.perf_counter()
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    cfg, arch = _arch(arch_name, **changes)
    params = _params(r, arch_name, cfg, arch, tdt, mesh, overrides)
    ctx = ShardCtx(mesh, overrides=overrides)
    batch = _batch(r, cfg, SERVE_ROWS, SERVE_SEQ + DECODE_STEPS, SERVE_SEED,
                   tdt)
    toks = batch["tokens"]
    prompt = dict(batch, tokens=toks[:, :SERVE_SEQ])
    arrays = {}
    with torch.no_grad(), cache_dtype(
            torch.float32 if f32_cache else torch.bfloat16):
        prompt = {k: ctx.place(v, "dp", *([None] * (v.ndim - 1)))
                  for k, v in prompt.items()}
        state, n, logits = arch.prefill(params, prompt, cfg, ctx,
                                        max_len=MAX_LEN)
        arrays["prefill"] = _np(logits)
        for i in range(decode_steps):
            tok = ctx.place(toks[:, SERVE_SEQ + i:SERVE_SEQ + i + 1], "dp",
                            None)
            state, n, logits = arch.decode(params, state, n, tok, cfg, ctx)
            arrays[f"decode{i}"] = _np(logits)
    r.write(mesh, key, arrays)
    r.record["seconds"][key] = time.perf_counter() - t0


class cache_dtype:
    """The decode caches in ``dtype`` (bfloat16 is the port's default):
    float32 caches (the attention K/V and Mamba2's conv state) keep
    float32 runs from rounding to bfloat16, as
    ``tests/_lm_reference.f32_caches`` does for both packages."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        from repro_torch.models import attention, transformer, zamba2
        self.saved = [(f, f.__defaults__) for f in (
            attention.make_cache, transformer.init_caches)]
        self.mamba = zamba2.mamba_state_init
        attention.make_cache.__defaults__ = (self.dtype, None)
        transformer.init_caches.__defaults__ = (self.dtype, None)
        if self.dtype == self.torch_f32():
            init = self.mamba

            def f32_state(cfg, batch, device=None):
                st = init(cfg, batch, device)
                return dict(st, conv=st["conv"].float())
            zamba2.mamba_state_init = f32_state
        return self

    @staticmethod
    def torch_f32():
        import torch
        return torch.float32

    def __exit__(self, *exc):
        from repro_torch.models import zamba2
        for f, d in self.saved:
            f.__defaults__ = d
        zamba2.mamba_state_init = self.mamba


# ---------------------------------------------------------------------------
# Suites
# ---------------------------------------------------------------------------
DM = ("data", "model")
POD = ("pod", "data", "model")

#: (key, runner, mesh shape, names, kwargs): ranks 0-3 and 4-7 run their
#: lists side by side, then every rank the pod mesh's
LM_HALVES = (
    (("train/f32/2x2", "train", (2, 2), {"dtype": "f32"}),
     ("serve/f32/2x2", "serve", (2, 2), {"dtype": "f32", "f32_cache": True}),
     ("train/bf16/2x2", "train", (2, 2), {"dtype": "bf16"}),
     ("serve/bf16/2x2", "serve", (2, 2), {"dtype": "bf16"}),
     ("train/f32/4x1", "train", (4, 1), {"dtype": "f32"}),
     ("serve/f32/4x1", "serve", (4, 1), {"dtype": "f32", "f32_cache": True})),
    (("train/f32/1x4", "train", (1, 4), {"dtype": "f32"}),
     ("serve/f32/1x4", "serve", (1, 4), {"dtype": "f32", "f32_cache": True}),
     ("flash/f32/1x4", "serve", (1, 4), {"dtype": "f32", "f32_cache": True,
                                         "decode_kv_seq_shard": True}),
     ("dense/bf16/1x4", "serve", (1, 4), {"dtype": "bf16"}),
     ("flash/bf16/1x4", "serve", (1, 4), {"dtype": "bf16",
                                          "decode_kv_seq_shard": True}),
     ("serve/f32/1x4+tponly", "serve", (1, 4),
      {"dtype": "f32", "f32_cache": True, "overrides": {"fsdp": None}})),
)
LM_POD = (
    ("train/f32/2x2x2", "train", (2, 2, 2), {"dtype": "f32"}),
    ("serve/f32/2x2x2", "serve", (2, 2, 2), {"dtype": "f32",
                                             "f32_cache": True}),
)
RUNNERS = {"train": train_case, "serve": serve_case}


def blocks_case(r: Rank, mesh, key: str, spec) -> None:
    """Which block of a (8, 4) ``arange`` each rank holds under
    ``spec``: its local part, recorded by rank."""
    from repro_torch.sharding import distribute, placements
    full = r.torch.arange(32, dtype=r.torch.float32).reshape(8, 4)
    local = distribute(full, mesh, placements(mesh, spec)).to_local()
    r.record.setdefault("blocks", {})[key] = {
        "coord": list(mesh.get_coordinate()), "local": local.tolist()}


def suite_lm(r: Rank) -> None:
    meshes = {}
    for half, cases in enumerate(LM_HALVES):
        for _, _, shape, _ in cases:
            if (half, shape) not in meshes:
                meshes[(half, shape)] = r.mesh(shape, DM, first=4 * half)
    for _, _, shape, _ in LM_POD:
        meshes[("pod", shape)] = r.mesh(shape, POD)
    half = r.rank // 4
    for key, kind, shape, kw in LM_HALVES[half]:
        RUNNERS[kind](r, meshes[(half, shape)], key, "yi-9b", **kw)
    r.torch.distributed.barrier()
    for key, kind, shape, kw in LM_POD:
        RUNNERS[kind](r, meshes[("pod", shape)], key, "yi-9b", **kw)
    blocks_case(r, meshes[("pod", (2, 2, 2))], "pod",
                (("pod", "data"), "model"))


#: the ``families`` suite's serving cases on (2, 2): olmoe with each
#: dispatch, and one prefill plus one decode step of the other families
TRAIN_SERVE = (
    ("moe/ep", "olmoe-1b-7b", {"moe": {"dispatch": "ep"}}),
    ("moe/local", "olmoe-1b-7b", {"moe": {"dispatch": "local"}}),
    ("family/zamba2-7b", "zamba2-7b", {}),
    ("family/xlstm-125m", "xlstm-125m", {}),
    ("family/whisper-tiny", "whisper-tiny", {}),
    ("family/qwen2-moe-a2.7b", "qwen2-moe-a2.7b", {}),
)
TRAINER = dict(total_steps=4, ckpt_every=2, log_every=1)


def suite_families(r: Rank) -> None:
    m22 = r.mesh((2, 2), DM)
    for key, name, kw in TRAIN_SERVE:
        serve_case(r, m22, key, name, "f32", f32_cache=True,
                   decode_steps=1, **kw)


def suite_train(r: Rank) -> None:
    m22 = r.mesh((2, 2), DM)
    m41 = r.mesh((4, 1), DM)
    # 8-bit AdamW state and int8 compression with error feedback, on the
    # MoE model (its expert products take part in the backward)
    train_case(r, m22, "train8bit/olmoe-1b-7b", "olmoe-1b-7b", "f32",
               quantize_state=True, compression=True)
    seeded_init_case(r, m22)
    checkpoint_case(r, m22)
    trainer_case(r, m22, m41)
    serve_engine_case(r, m22)


def serve_engine_case(r: Rank, mesh) -> None:
    """``ServeEngine(mesh=)`` with TP-only params (placed from whole
    float32 params) generating greedily, beside the same engine on one
    device: the tokens of both."""
    from repro_torch import params_from_reference
    from repro_torch.serve import ServeEngine
    torch = r.torch
    cfg, arch = _arch("yi-9b", serve_params_tp_only=True)
    tree = read_params(os.path.join(r.out, "params_yi-9b.npz"),
                       arch.param_specs(cfg))
    params = params_from_reference(tree, device=r.device,
                                   dtype=torch.float32)
    batch = _batch(r, cfg, SERVE_ROWS, SERVE_SEQ, SERVE_SEED, torch.float32)
    with cache_dtype(torch.float32):
        sharded = ServeEngine(arch, params, mesh=mesh, max_len=MAX_LEN,
                              device=r.device).generate(batch, 4)
        one = ServeEngine(arch, params, max_len=MAX_LEN,
                          device=r.device).generate(batch, 4)
    from repro_torch.models.common import tree_leaves
    placed = list(tree_leaves(ServeEngine(
        arch, params, mesh=mesh, max_len=MAX_LEN, device=r.device).params,
        torch.is_tensor))
    # TP-only: nothing sharded over "data" (mesh dim 0), the heads over
    # "model"
    r.check("serve_engine_tp_only", all(
        t.device_mesh is mesh and not hasattr(t.placements[0], "dim")
        for t in placed) and any(hasattr(t.placements[1], "dim")
                                 for t in placed))
    r.record["serve_engine"] = {"mesh": sharded.tolist(),
                                "one": one.tolist()}


def seeded_init_case(r: Rank, mesh) -> None:
    """``init_params`` on the mesh draws the single-device params: every
    leaf gathered equals the one-device draw bit for bit."""
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.sharding import full_tensor
    torch = r.torch
    cfg, arch = _arch("yi-9b")
    specs = arch.param_specs(cfg)
    one = init_params(torch.Generator(r.device).manual_seed(7), specs,
                      r.device)
    sh = init_params(torch.Generator(r.device).manual_seed(7), specs,
                     r.device, mesh=mesh)
    leaves = list(zip(tree_leaves(one, torch.is_tensor),
                      tree_leaves(sh, torch.is_tensor)))
    r.check("seeded_init_bitwise",
            all(torch.equal(full_tensor(b), a) for a, b in leaves))
    r.check("seeded_init_sharded",
            sum(b.to_local().numel() for _, b in leaves)
            < sum(a.numel() for a, _ in leaves))


def checkpoint_case(r: Rank, mesh) -> None:
    """One step on the mesh, then a checkpoint of the state for the
    reference to restore on one device; the gathered state beside it."""
    from repro_torch.checkpointing import save_checkpoint
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    torch = r.torch
    cfg, arch = _arch("yi-9b")
    params = _params(r, "yi-9b", cfg, arch, torch.bfloat16, mesh)
    opt = AdamWConfig(**TRAIN_OPT)
    state = init_opt_state(params, opt)
    step = make_train_step(arch, opt, ShardCtx(mesh))
    params, state, _ = step(params, state, _batch(
        r, cfg, TRAIN_ROWS, TRAIN_SEQ, TRAIN_SEED, torch.bfloat16))
    tree = {"params": params, "opt": state}
    save_checkpoint(os.path.join(r.out, "ckpt"), 1, tree)
    arrays = {path: _np(t) for path, t in keypaths(tree)}
    r.write(mesh, "ckpt_state", arrays)


def trainer_case(r: Rank, m22, m41) -> None:
    """A ``Trainer`` on (2, 2) checkpointing every 2 steps, resumed on
    (4, 1) from its last checkpoint (the state bitwise), then re-meshed
    onto (2, 2) (bitwise again) for one more step; beside it the same
    steps on one device; then four steps in float32 on (2, 2), on one
    device, and on one device from an init one ulp up."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.sharding import full_tensor
    from repro_torch.train import Trainer, TrainLoopConfig
    torch = r.torch
    cfg, arch = _arch("yi-9b")
    opt = AdamWConfig(**TRAIN_OPT)
    lc = TrainLoopConfig(ckpt_dir=os.path.join(r.out, "trainer"), **TRAINER)
    t0 = time.perf_counter()
    tr = Trainer(arch, opt, lc, device=r.device, mesh=m22)
    hist = tr.run()

    def whole(tree):
        return [full_tensor(t).clone() for t in tree_leaves(tree,
                                                            torch.is_tensor)]
    saved = whole(tr._state_tree())
    tr2 = Trainer(arch, opt, lc, device=r.device, mesh=m41)
    r.check("trainer_resumed", tr2.try_resume() and tr2.step == 4,
            tr2.step)
    got = whole(tr2._state_tree())
    r.check("trainer_resume_bitwise",
            all(torch.equal(a, b) for a, b in zip(saved, got)))
    r.check("trainer_resume_placed",
            all(t.device_mesh is m41 for t in tree_leaves(
                tr2.params, torch.is_tensor)))
    tr2.remesh(m22)
    r.check("remesh_bitwise", all(torch.equal(a, b) for a, b in zip(
        saved, whole(tr2._state_tree()))))
    r.check("remesh_event", tr2.events[-1]["kind"] == "remesh"
            and tr2.events[-1]["step"] == 4, tr2.events)
    r.check("remesh_placed", all(t.device_mesh is m22 for t in tree_leaves(
        tr2.params, torch.is_tensor)))
    met = tr2.run_step()
    # the same five steps on one device
    ref = Trainer(arch, opt, dataclasses.replace(
        lc, ckpt_dir=os.path.join(r.out, "trainer_one")), device=r.device)
    ref_hist = ref.run()
    ref_met = ref.run_step()
    r.record["trainer"] = {
        "losses": [h["loss"] for h in hist], "step5": met["loss"],
        "ref_losses": [h["loss"] for h in ref_hist],
        "ref_step5": ref_met["loss"]}
    # the same four steps in float32 (params cast from the bf16 draw), on
    # (2, 2), on one device, and on one device from an init one float32
    # ulp up (what rounding alone does to later losses)
    f32 = {}
    for name, mesh in (("mesh", m22), ("one", None), ("one_ulp", None)):
        t = Trainer(arch, opt, dataclasses.replace(
            lc, ckpt_dir=os.path.join(r.out, f"trainer_f32_{name}")),
            device=r.device, mesh=mesh)
        t.init_state()
        t.params = tree_map(lambda p: p.float(), t.params, torch.is_tensor)
        if name == "one_ulp":
            t.params = tree_map(lambda p: torch.nextafter(
                p, torch.full_like(p, math.inf)), t.params, torch.is_tensor)
        t.opt_state = init_opt_state(t.params, opt)
        f32[name] = [h["loss"] for h in t.run()]
    r.record["trainer_f32"] = f32
    r.record["seconds"]["trainer"] = time.perf_counter() - t0


def step_case(r: Rank, mesh, key: str, arch_name: str,
              rows: int = TRAIN_ROWS) -> None:
    """One float32 AdamW step from the parent's params
    (``params_<arch>.npz``) on ``rows`` x ``TRAIN_SEQ`` tokens; writes
    the step's metrics and its first and second moments, whole."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    torch = r.torch
    t0 = time.perf_counter()
    cfg, arch = _arch(arch_name)
    params = _params(r, arch_name, cfg, arch, torch.float32, mesh)
    opt = AdamWConfig(**TRAIN_OPT)
    step = make_train_step(arch, opt, ShardCtx(mesh))
    batch = _batch(r, cfg, rows, TRAIN_SEQ, TRAIN_SEED, torch.float32)
    _, state, met = step(params, init_opt_state(params, opt), batch)
    arrays = {f"metric_{k}": np.asarray(float(v)) for k, v in met.items()}
    for key_ in ("m", "v"):
        for (path, _), t in zip(keypaths(state[key_]),
                                tree_leaves(state[key_], torch.is_tensor)):
            arrays[key_ + path] = _np(t)
    r.write(mesh, key, arrays)
    r.record["seconds"][key] = time.perf_counter() - t0


#: the ``recurrent`` suite (8 ranks): a sharded training step of the
#: families whose scans run on each rank's blocks, on (2, 2) in ranks
#: 0-3, then xLSTM's on (1, 8) over 8 rows, where its 4 heads do not
#: divide "model" and the scans split the rows over both mesh dims
RECURRENT = ("whisper-tiny", "xlstm-125m")
ROWS_SPLIT = ("xlstm-125m", (1, 8), 8)
#: on ROWS_SPLIT's (1, 8) mesh, 4 heads and 4 rows, too few for it:
#: the products' columns split over "model", xLSTM's scans whole there
COLS_SPLIT = RECURRENT


def suite_recurrent(r: Rank) -> None:
    m22 = r.mesh((2, 2), DM)
    name, shape, rows = ROWS_SPLIT
    wide = r.mesh(shape, DM)
    if r.rank < 4:
        for arch in RECURRENT:
            step_case(r, m22, f"step/{arch}", arch)
    r.torch.distributed.barrier()
    step_case(r, wide, f"rows/{name}", name, rows=rows)
    for arch in COLS_SPLIT:
        step_case(r, wide, f"cols/{arch}", arch)
        serve_case(r, wide, f"colserve/{arch}", arch, "f32", f32_cache=True,
                   decode_steps=1)


#: the ``ce`` suite: the vocabulary-parallel cross entropy on (2, 2) and
#: (1, 4), float32 logits split over "model", z-loss and mask on and off
CE_ROWS, CE_SEQ, CE_VOCAB, CE_SEED, CE_Z = 4, 6, 64, 11, 1e-4
CE_CASES = tuple((f"ce/{a}x{b}/z{int(z)}/mask{int(mk)}", (a, b), z, mk)
                 for a, b in ((2, 2), (1, 4)) for z in (False, True)
                 for mk in (False, True))


def ce_inputs():
    """Seeded (logits (rows, seq, vocab) float32, labels (rows, seq),
    mask (rows, seq) float32 with zeros): the first rows' labels hit
    every eighth of the vocabulary, so that every block on a (1, 4) or
    (2, 2) mesh holds some."""
    rng = np.random.default_rng(CE_SEED)
    logits = rng.standard_normal((CE_ROWS, CE_SEQ, CE_VOCAB)).astype(
        np.float32) * 3
    labels = rng.integers(0, CE_VOCAB, (CE_ROWS, CE_SEQ)).astype(np.int32)
    labels.reshape(-1)[:8] = np.arange(8) * (CE_VOCAB // 8) + 3
    mask = (rng.random((CE_ROWS, CE_SEQ)) < 0.7).astype(np.float32)
    return logits, labels, mask


def ce_case(r: Rank, mesh, key: str, z_loss: bool, masked: bool) -> None:
    """The loss and its grad with respect to the logits, whole; checks
    that the grad keeps the logits' vocabulary split."""
    from torch.distributed.tensor import Shard
    from repro_torch.models.common import cross_entropy
    from repro_torch.sharding import ShardCtx, on_mesh
    torch = r.torch
    ctx = ShardCtx(mesh)
    logits, labels, mask = (torch.from_numpy(a).to(r.device)
                            for a in ce_inputs())
    with on_mesh():
        x = ctx.place(logits, "dp", None, "tp").detach().requires_grad_()
        loss = cross_entropy(
            x, ctx.place(labels, "dp", None),
            mask=ctx.place(mask, "dp", None) if masked else None,
            z_loss=CE_Z if z_loss else 0.0)
        loss.backward()
    split = [isinstance(p, Shard) and p.dim == 2 for p in x.grad.placements]
    r.check(f"{key} grad split over the vocabulary", any(split),
            x.grad.placements)
    r.write(mesh, key, {"loss": _np(loss), "grad": _np(x.grad)})


def suite_ce(r: Rank) -> None:
    meshes = {shape: r.mesh(shape, DM) for shape in ((2, 2), (1, 4))}
    for key, shape, z, mk in CE_CASES:
        ce_case(r, meshes[shape], key, z, mk)


SUITES = {"lm": suite_lm, "families": suite_families, "train": suite_train,
          "recurrent": suite_recurrent, "ce": suite_ce}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--suite", required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    import logging
    import warnings
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
        world_size=args.world, timeout=datetime.timedelta(seconds=300))
    try:
        r = Rank(args.rank, args.world, args.device, args.out)
        t0 = time.perf_counter()
        SUITES[args.suite](r)
        r.record["seconds"]["suite"] = time.perf_counter() - t0
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
