"""How much the summation order of the cross entropy moves one device's
bf16 training, at chip_smoke.py phase 2l (ii)'s sizes (qwen3-14b, 2 of
its 40 layers, 4 x 256 tokens, AdamW at lr 1e-4).

    python3 tools/ce_order_witness.py [--seeds 2027,2127] \\
        [--out build/ce_order_witness.json]

For each seed, two single-device runs from the same params: the port's
cross entropy ("whole": one logsumexp over the vocabulary) and the same
function summed as the vocabulary-parallel cross entropy sums it on a
mesh whose "model" axis is 4 ("blocks4": each block's max, sum of exps
and gold logit joined in block order, the backward ``softmax - onehot``
per block).  The two agree to f32 rounding; each run takes two steps.
Printed per seed and run: the first batch's loss before and after the
first step, the second step's loss (the second batch after the first
step) and the second batch's loss at the init params; and between the
two runs, the worst leaf's gap of the f32 master's change over its norm
(as phase 2l (ii) reads it against the mesh).  Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _BlocksCE(torch.autograd.Function):
    """(logsumexp, gold logit) of f32 logits ``x`` (..., V) over ``n``
    vocabulary blocks, in ``models.common._SplitVocabCE``'s arithmetic
    with its all-reduces taken in block order."""

    @staticmethod
    def forward(ctx, x, labels, n: int):
        blocks = x.chunk(n, dim=-1)
        m = torch.amax(blocks[0], dim=-1)
        for b in blocks[1:]:
            m = torch.maximum(m, torch.amax(b, dim=-1))
        s = torch.sum(torch.exp(blocks[0] - m[..., None]), dim=-1)
        for b in blocks[1:]:
            s = s + torch.sum(torch.exp(b - m[..., None]), dim=-1)
        lse = m + torch.log(s)
        gold = torch.zeros_like(lse)
        lo = 0
        for b in blocks:
            idx = labels.long() - lo
            hit = (idx >= 0) & (idx < b.shape[-1])
            idx = torch.where(hit, idx, 0)
            gold = gold + torch.where(
                hit, torch.gather(b, -1, idx[..., None])[..., 0], 0.0)
            lo += b.shape[-1]
        ctx.save_for_backward(x, lse, labels)
        ctx.n = n
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        x, lse, labels = ctx.saved_tensors
        grads, lo = [], 0
        for b in x.chunk(ctx.n, dim=-1):
            grad = torch.exp(b - lse[..., None]) * g_lse[..., None]
            idx = labels.long() - lo
            hit = (idx >= 0) & (idx < b.shape[-1])
            grad.scatter_add_(-1, torch.where(hit, idx, 0)[..., None],
                              torch.where(hit, g_gold, 0.0)[..., None])
            grads.append(grad)
            lo += b.shape[-1]
        return torch.cat(grads, dim=-1), None, None


def blocks_ce(n: int):
    def cross_entropy(logits, labels, mask=None, z_loss=0.0):
        assert mask is None and not z_loss
        lse, gold = _BlocksCE.apply(logits.float(), labels, n)
        return torch.mean(lse - gold)
    return cross_entropy


def run(arch, cfg, opt, seed, batches, ce):
    """Two steps from the seeded params with ``ce`` as the model's
    cross entropy; returns (losses, the f32 master's change per leaf in
    bf16)."""
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.optim import init_opt_state
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import make_train_step
    saved = transformer.cross_entropy
    transformer.cross_entropy = ce
    try:
        ctx = ShardCtx()
        params = init_params(torch.Generator("cuda").manual_seed(seed),
                             arch.param_specs(cfg))
        init = [t.clone() for t in tree_leaves(params, torch.is_tensor)]
        state = init_opt_state(params, opt)
        step = make_train_step(arch, opt, ctx)
        out = {}
        with torch.no_grad():
            out["loss2_init"] = float(arch.loss(params, batches[1], cfg,
                                                ctx)[0])
        params, state, met1 = step(params, state, batches[0])
        out["loss1"] = float(met1["loss"])
        with torch.no_grad():
            out["loss1_after"] = float(arch.loss(params, batches[0], cfg,
                                                 ctx)[0])
        delta = [(ma - p0.float()).to(torch.bfloat16) for p0, ma in zip(
            init, tree_leaves(state["master"], torch.is_tensor))]
        del init
        _, _, met2 = step(params, state, batches[1])
        out["loss2"] = float(met2["loss"])
        return out, delta
    finally:
        transformer.cross_entropy = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="2027,2127")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_order_witness: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.models import make_arch
    from repro_torch.optim import AdamWConfig
    world = _load("_lm_chip")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__}", flush=True)
    _, cfg, _ = world.chip_cfgs()
    arch, C = make_arch(cfg), world.CHIP
    opt = AdamWConfig(**world.CHIP_OPT)
    batches = [{"tokens": torch.from_numpy(world.chip_tokens(
        cfg.vocab, C["train_rows"], C["train_seq"], salt=k)).cuda()}
        for k in (1, 2)]
    from repro_torch.models.common import cross_entropy
    records = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        whole, d_whole = run(arch, cfg, opt, seed, batches, cross_entropy)
        torch.cuda.empty_cache()
        blocks, d_blocks = run(arch, cfg, opt, seed, batches,
                               blocks_ce(args.blocks))
        worst = max(float(torch.linalg.vector_norm(
            (a.float() - b.float()).flatten()) / max(float(
                torch.linalg.vector_norm(a.float().flatten())), 1e-30))
            for a, b in zip(d_whole, d_blocks))
        del d_whole, d_blocks
        torch.cuda.empty_cache()
        rec = {"whole": whole, f"blocks{args.blocks}": blocks,
               "worst_leaf_master_change_gap": worst,
               "loss2_moved": blocks["loss2"] - whole["loss2"],
               "loss1_after_moved": (blocks["loss1_after"]
                                     - whole["loss1_after"])}
        records[seed] = rec
        print(f"seed {seed}: " + "; ".join(
            f"{k}: loss1 {v['loss1']:.6f}, loss1_after "
            f"{v['loss1_after']:.6f}, loss2 {v['loss2']:.6f} (at init "
            f"{v['loss2_init']:.6f})" for k, v in rec.items()
            if isinstance(v, dict))
            + f"; moved by the order: loss2 {rec['loss2_moved']:.4g}, "
            f"loss1_after {rec['loss1_after_moved']:.4g}; worst leaf's "
            f"master change gap {worst:.4g}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "records": records}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
