"""The dry run's jobs of ``chip_smoke.py`` phase 2m, each one process on
the card's host CPU (a fake world of its own; no device):

    python tests/_dryrun_chip.py --job comms --out FILE
    python tests/_dryrun_chip.py --job cell --arch A --cell C \\
        --mesh pod|multipod --out FILE [--full-depth]
    python tests/_dryrun_chip.py --job stopped --mesh pod|multipod \\
        --out FILE

``comms`` (2m (iv)): phase 2l's dense decode step (qwen3-14b at 8 of 40
layers, TP-only params, 4 rows on caches of 272 holding 256) and its
FSDP + TP training step (2 layers, 4 x 256 tokens, f32 AdamW), traced on
a fake (2, 4) world and walked: per collective kind the count, operand
bytes and wire bytes; and the same walk with every group read at twice
its size (the planted fault).  ``cell`` (2m (vi)): ``lower_cell``'s
record.  ``stopped`` (2m (vii)): the cells that stopped in torch 2.11's
DTensor before the repair, reduced.  The processes import torch, numpy
and ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def comms() -> dict:
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline import graph_walk as gw
    from repro_torch.sharding import MeshShape
    chip = _load("_lm_chip")
    serve, train, _ = chip.chip_cfgs()
    C = chip.CHIP
    mesh = dryrun.fake_mesh(MeshShape((2, 4), ("data", "model")))
    out = {}
    t0 = time.perf_counter()
    with dryrun.traceable_dtensor():
        graphs = {
            "dense_decode": dryrun.trace_lm(
                serve, "decode", mesh, C["rows"], 1, max_len=C["max_len"],
                cache_len=C["prompt"], token_dtype=torch.int64),
            "step": dryrun.trace_lm(
                train, "train", mesh, C["train_rows"], C["train_seq"],
                opt_cfg=AdamWConfig(**chip.CHIP_OPT),
                token_dtype=torch.int64)}
    out["trace_s"] = time.perf_counter() - t0
    for name, gm in graphs.items():
        out[name] = gw.walk(gm, 8).collective_ops()
    group = gw._group

    def doubled(args, kwargs):
        g, ranks = group(args, kwargs)
        return (None, None) if g is None else (2 * g, ranks)
    gw._group = doubled
    try:
        out["fault_doubled_group"] = {
            name: gw.walk(gm, 8).collective_ops()
            for name, gm in graphs.items()}
    finally:
        gw._group = group
    dryrun.end_fake_world()
    return out


#: the records that stopped in torch 2.11's DTensor on the card's host
#: before the model code ran those ops on local blocks: (arch, cells),
#: on both meshes
STOPPED = (("olmoe-1b-7b", ("train_4k",)),
           ("qwen2-moe-a2.7b", ("train_4k", "prefill_32k", "decode_32k")),
           ("zamba2-7b", ("train_4k", "prefill_32k", "decode_32k",
                          "long_500k")),
           ("xlstm-125m", ("train_4k",)), ("whisper-tiny", ("train_4k",)))


def stopped(multi_pod: bool) -> dict:
    """2m (vii): the formerly stopped records' cells on one mesh, at the
    sweep test's reduced sizes (``tests/_dryrun_sweep.py`` ``shrink``,
    ``SMALL``): per cell its status and peak bytes a device, or its
    error."""
    from repro_torch.launch import dryrun
    sweep = _load("_dryrun_sweep")
    out = {}
    try:
        for arch, cells in STOPPED:
            for name in cells:
                try:
                    rec = dryrun.lower_cell(arch, name, multi_pod,
                                            shrink=sweep.shrink,
                                            cell=sweep.SMALL[name])
                    out[f"{arch}:{name}"] = {
                        "status": rec["status"],
                        "peak_bytes": rec["memory"]["peak_bytes"]}
                except Exception as e:      # the phase reports it
                    out[f"{arch}:{name}"] = {
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}"[:600],
                        "traceback": traceback.format_exc()[-3000:]}
    finally:
        dryrun.end_fake_world()
    return {"cells": out}


def cell(arch: str, cell_name: str, multi_pod: bool, full_depth: bool):
    from repro_torch.launch import dryrun
    try:
        return dryrun.lower_cell(arch, cell_name, multi_pod,
                                 full_depth=full_depth)
    finally:
        dryrun.end_fake_world()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", choices=["comms", "cell", "stopped"],
                    required=True)
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--cell", default="train_4k")
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--full-depth", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.job == "comms":
        rec = comms()
    elif args.job == "stopped":
        rec = stopped(args.mesh == "multipod")
    else:
        rec = cell(args.arch, args.cell, args.mesh == "multipod",
                   args.full_depth)
    rec = {**rec, "process_s": time.perf_counter() - t0}
    with open(args.out, "w") as f:
        json.dump(rec, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
