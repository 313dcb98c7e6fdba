"""How well conditioned zamba2-7b and xlstm-125m are at their random init
and after ``chip_smoke.scale_scores``, on the card: why phase 2j checks
the weights with their query and key projections rescaled, and why
phase 2k (iii) trains xlstm-125m at its true fan-in (PERF.md).

Run on a GPU host from the repo root (about a minute on an H100):

    python3 tools/lm_conditioning.py [--out chiprun_out/lm_conditioning.json]

It draws the params as ``chip_smoke.py`` phase 2j does (same seeds) and
prints one JSON object with, under ``reference_init`` and under
``scaled_scores`` (the same params, ``scale_scores`` applied):

* ``xlstm``: the whole model's logits on 2 x 256 tokens in f32 on the
  card and on the host, and in f64 on the card; each f32 run's largest
  gap to the f64 one, and each block's largest |block(x) - x|;
* ``zamba_unit``: one firing unit (three Mamba2 blocks and the shared
  block with its LoRA) in f32 and f64 on the card, 2 x 320 tokens, and
  the shared block's query magnitudes;
* ``zamba_f32_decode``: decode vs prefill logits in f32 after 512
  prompt tokens and 4 decode steps, on phase 2j's tokens and on tokens
  drawn from another seed;

and, under ``xlstm_train``, phase 2k (iii)'s straight run (the
``Trainer``'s data and optimizer, bf16) from the Trainer's draw as it
is, with ``scale_scores`` and at its true fan-in (``trainer_fan_in``,
what (iii) trains): the grad norm on the first batch, the leaf with the
largest share of its square, the losses and grad norms of
``TRAINER_STEPS`` steps, and the fall of those batches' mean loss over
the run (what (iii) gates).

The port casts to float32 where the reference does; the f64 runs keep
float64 through those casts with :func:`keep_float64`, a patch of
``Tensor.float``, ``torch.zeros`` and ``torch.full`` undone on exit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import batch_for_step  # noqa: E402
from repro_torch.models import make_arch, xlstm as txl, zamba2 as tzb  # noqa: E402
from repro_torch.models.common import init_params, rms_norm, tree_map  # noqa: E402
from repro_torch.models.transformer import embed, unembed  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.sharding import ShardCtx  # noqa: E402
from repro_torch.train import Trainer, TrainLoopConfig  # noqa: E402

CTX = ShardCtx()


@contextlib.contextmanager
def keep_float64():
    """Within the block, ``t.float()`` of a float64 tensor and float32
    zeros/full come out float64."""
    real = torch.Tensor.float, torch.zeros, torch.full

    def as_f64(dtype):
        return torch.float64 if dtype in (None, torch.float32) else dtype

    torch.Tensor.float = (lambda self: self if self.dtype == torch.float64
                          else real[0](self))
    torch.zeros = lambda *a, dtype=None, **k: real[1](*a, dtype=as_f64(dtype),
                                                      **k)
    torch.full = lambda *a, dtype=None, **k: real[2](
        *a, dtype=torch.float64 if dtype == torch.float32 else dtype, **k)
    try:
        yield
    finally:
        torch.Tensor.float, torch.zeros, torch.full = real


def gap(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def params(name, seed, scaled):
    cfg = get_config(name)
    specs = make_arch(cfg).param_specs(cfg)
    p = init_params(torch.Generator("cuda").manual_seed(cs.SEED + seed),
                    specs)
    if scaled:
        cs.scale_scores(p, specs)
    return cfg, p


def prompt_tokens(cfg, seed, rows, n):
    tg = torch.Generator("cuda").manual_seed(cs.SEED + seed)
    toks = torch.randint(0, cfg.vocab, (cs.FAMILY_BATCH, cs.FAMILY_PROMPT),
                         generator=tg, device="cuda", dtype=torch.int32)
    return toks[:rows, :n]


def xlstm_report(scaled):
    cfg, p = params("xlstm-125m", 5, scaled)
    toks = prompt_tokens(cfg, 6, *cs.F32_DECODE_CASES[cfg.arch])

    def run(pp, tk, deltas=None):
        x = embed(pp, tk, cfg, CTX)
        for key, is_s in txl._layer_keys(cfg):
            block = txl.slstm_block if is_s else txl.mlstm_block
            y = block(pp["layers"][key], x, cfg, CTX)[0]
            if deltas is not None:
                deltas[key] = float((y - x).abs().max())
            x = y
        return unembed(pp, rms_norm(x, pp["ln_final"], cfg.norm_eps), cfg,
                       CTX)

    p32 = tree_map(lambda t: t.float(), p, torch.is_tensor)
    p64 = tree_map(lambda t: t.double(), p, torch.is_tensor)
    deltas = {}
    with torch.inference_mode():
        card = run(p32, toks, deltas)
        host = run(tree_map(lambda t: t.cpu(), p32, torch.is_tensor),
                   toks.cpu())
        with keep_float64():
            f64 = run(p64, toks)
    return {"card_vs_host": gap(card, host), "card_vs_f64": gap(card, f64),
            "host_vs_f64": gap(host, f64),
            "logit_max_abs": float(f64.abs().max()),
            "block_delta_max_abs": deltas}


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _named_leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def xlstm_train_report(weights):
    cfg = get_config("xlstm-125m")
    arch = make_arch(cfg)
    opt = AdamWConfig(**cs.TRAINER_OPT)
    tr = Trainer(arch, opt, TrainLoopConfig(
        seed=cs.SEED,
        ckpt_dir=os.path.join(ROOT, "build", "lm_conditioning_ckpt")))
    if weights == "fan_in":
        cs.trainer_fan_in(tr)
    else:
        tr.init_state()
    if weights == "scaled_scores":
        cs.scale_scores(tr.params, arch.param_specs(cfg))
        tr.opt_state = init_opt_state(tr.params, opt)
    _, _, grads = tr._train_step.grads_of(
        tr.params, batch_for_step(tr.data_cfg, 0))
    sq = {k: float(g.float().square().sum())
          for k, g in _named_leaves(grads)}
    del grads
    top = max(sq, key=sq.get)
    steps = range(cs.TRAINER_STEPS)
    before = cs.batches_loss(arch, tr.params, tr.data_cfg, steps)
    hist = [tr.run_step() for _ in steps]
    return {"grad_norm": sum(sq.values()) ** 0.5, "largest_leaf": top,
            "largest_leaf_share": sq[top] / sum(sq.values()),
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "batches_fall": before - cs.batches_loss(arch, tr.params,
                                                     tr.data_cfg, steps)}


def zamba_reports(scaled):
    cfg, p = params("zamba2-7b", 3, scaled)
    toks = prompt_tokens(cfg, 4, cs.ZAMBA_UNIT_ROWS, cs.ZAMBA_UNIT_PROMPT)
    unit = {"up": tree_map(lambda t: t[1], p["units"], torch.is_tensor),
            "shared": p["shared"], "embed": p["embed"],
            "ln_final": p["ln_final"]}

    def unit_logits(pp, tk):
        h0 = embed(pp, tk, cfg, CTX)
        h = tzb.zamba_unit(cfg, CTX, pp["shared"], pp["up"], h0, h0, None,
                           fire=True)
        return unembed(pp, rms_norm(h, pp["ln_final"], cfg.norm_eps), cfg,
                       CTX)

    with torch.inference_mode():
        u32 = tree_map(lambda t: t.float(), unit, torch.is_tensor)
        c32 = unit_logits(u32, toks)
        x2n = rms_norm(torch.cat([embed(u32, toks, cfg, CTX)] * 2, -1),
                       u32["shared"]["ln_attn"], cfg.norm_eps)
        wq = u32["shared"]["wq"]
        q = x2n @ wq.reshape(wq.shape[0], -1)
        u64 = tree_map(lambda t: t.double(), unit, torch.is_tensor)
        with keep_float64():
            c64 = unit_logits(u64, toks)
        del u32, u64
        unit_rec = {"card32_vs_card64": gap(c32, c64),
                    "logit_max_abs": float(c64.abs().max()),
                    "q_abs_mean": float(q.abs().mean()),
                    "q_abs_max": float(q.abs().max())}

        arch = make_arch(cfg)
        b, s = cs.F32_DECODE_CASES[cfg.arch]
        steps = cs.LM_CHECK_STEPS
        p32 = tree_map(lambda t: t.float(), p, torch.is_tensor)
        del p
        torch.cuda.empty_cache()
        phase_toks = prompt_tokens(cfg, 4, b, s + steps)
        other = torch.randint(0, cfg.vocab, (b, s + steps), device="cuda",
                              generator=torch.Generator("cuda").manual_seed(
                                  cs.SEED + 100), dtype=torch.int32)
        decode = {}
        for name, tk in (("phase_2j_tokens", phase_toks),
                         ("other_tokens", other)):
            st, n, _ = arch.prefill(p32, {"tokens": tk[:, :s]}, cfg, CTX,
                                    max_len=s + 2 * steps)
            for i in range(s, s + steps):
                st, n, step = arch.decode(p32, st, n, tk[:, i:i + 1], cfg,
                                          CTX)
            ref = arch.prefill(p32, {"tokens": tk}, cfg, CTX,
                               max_len=s + 2 * steps)[2]
            decode[name] = gap(step[:, -1], ref[:, -1])
    return unit_rec, decode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    rec = {"card": torch.cuda.get_device_name(0)}
    for name, scaled in (("reference_init", False), ("scaled_scores", True)):
        part = {"xlstm": xlstm_report(scaled)}
        torch.cuda.empty_cache()
        part["zamba_unit"], part["zamba_f32_decode"] = zamba_reports(scaled)
        torch.cuda.empty_cache()
        rec[name] = part
    rec["xlstm_train"] = {}
    for weights in ("reference_init", "scaled_scores", "fan_in"):
        rec["xlstm_train"][weights] = xlstm_train_report(weights)
        torch.cuda.empty_cache()
    line = json.dumps(rec)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
