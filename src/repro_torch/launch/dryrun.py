"""The dry run's sharded byte counts, with no devices.

For every architecture, shape cell and variant on the production meshes
(``pod16x16`` and ``pod2x16x16``, as :class:`~repro_torch.sharding.
MeshShape`), the bytes one device holds of the params, the optimizer
state (train cells), the decode state (decode cells) and the batch, from
:func:`~repro_torch.models.common.abstract_params` shard shapes:

    python -m repro_torch.launch.dryrun [--arch ID|all] [--cell NAME|all]
        [--mesh pod|multipod|both] [--variant NAME] [--out FILE]

The per-cell config knobs (``CELL_OVERRIDES``, ``QUANTIZE_OPT``,
``DEPLOY_ACCUM``, ``_cfg_for``, ``_deploy``, ``VARIANTS``) are the
reference's (``src/repro/launch/dryrun.py``).  The reference also lowers
and compiles each cell on 512 forced XLA host devices and reads XLA's
``memory_analysis``, cost analysis and HLO; a torch process has neither
XLA nor those devices, so none of that is ported: the counts here are
the resident bytes the shardings imply, before any temporaries.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

from ..configs import ARCH_IDS, get_config
from ..models import CELLS, cell_supported, input_specs, make_arch
from ..models.common import abstract_params, tree_leaves
from ..optim import AdamWConfig, opt_state_specs
from .mesh import production_mesh_shape

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


def _cfg_for(arch_id: str, cell_name: str):
    cfg = get_config(arch_id)
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


def abstract_cell(arch_id: str, cell_name: str, mesh, variant="baseline"):
    """The cell's config and its abstract trees on ``mesh`` (a
    ``MeshShape``): ``params``, and ``opt`` (train), ``state`` (decode)
    and ``batch``; ``None`` where the cell is skipped."""
    cell = CELLS[cell_name]
    cfg = VARIANTS[variant](_cfg_for(arch_id, cell_name))
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


def cell_record(arch_id: str, cell_name: str, multi_pod: bool,
                variant: str = "baseline") -> dict:
    mesh = production_mesh_shape(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if variant != "baseline":
        mesh_name += f"+{variant}"
    rec = {"kind": "lm", "arch": arch_id, "cell": cell_name,
           "mesh": mesh_name, "devices": mesh.size}
    cfg, trees = abstract_cell(arch_id, cell_name, mesh, variant)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    recs = [cell_record(a, c, mp, args.variant)
            for a in archs for c in cells for mp in meshes]
    text = json.dumps(recs, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
