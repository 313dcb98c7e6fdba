"""Time sliding-window attention (K5) per dtype on one GPU.

    python3 tools/swa_probe.py [--root DIR ...] [--reps N] [--rounds N]
        [--out FILE] [--only SUBSTR,...] [--split-variants]

Each ``--root`` is the root of a checkout whose ``src/repro_torch`` is
timed (default: this one); several roots are timed in turns, ``--rounds``
times over (``--root A --root B --rounds 2`` gives A, B, A, B), each in
its own subprocess, so that two versions of K5 are compared within one
call on one card.  At gemma2-27b's local layer (``chip_smoke.GEMMA2_LOCAL``:
B=1, 32 query and 16 KV heads, head dim 128, window 4096, tq 128, S=8192),
CUDA-event medians:

* ``ops.swa`` in float16, float32 and bfloat16, with softcap 50 and with
  it off;
* ``F.scaled_dot_product_attention`` in each dtype with the same bool band
  mask (K/V repeated per query head outside the timing; float32 with TF32
  off), the yardstick the port never calls, and its largest difference
  from K5 with softcap off;
* K5's largest difference from its plain version (softcap 50).

Before the roots, it builds ``tools/tf32_probe.cu`` and shows how
``mma.sync`` reads an f32 bit pattern given as a ``.tf32`` operand
(truncated, rounded to nearest, ties away or even, or in full), and the
rate of ``mma.sync.m16n8k8`` TF32 products with nothing else to do
(every SM, 8 warps each, 8 independent accumulators per warp), the
ceiling of ``swa_tf32.cu``'s design.  Each root's ptxas registers and
spills per K5 instance are printed with its first round.

``--split-variants`` adds, as roots after the others, copies of this
checkout's ``src`` (under ``build/swa_variants/``) whose
``csrc/swa_tf32.cu`` forms the TF32 halves of an f32 operand otherwise:
``rna-small`` rounds the small half to nearest (``cvt.rna``) instead of
leaving it to the tensor cores' truncation, ``rna`` rounds both halves
(big = tf32(x), small = tf32(x - big)).

Prints the card's name and power limit; the last line is one JSON object
with every number (``--out`` writes it too).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMMA2_LOCAL = {"batch": 1, "hq": 32, "hkv": 16, "head_dim": 128,
                "window": 4096, "softcap": 50.0, "tq": 128, "seq": 8192}


def _child(root: str, reps: int, only: str | None) -> dict:
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import swa as kswa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GEMMA2_LOCAL
    gen = torch.Generator(device="cuda").manual_seed(20211228)
    b, s, d, w = cfg["batch"], cfg["seq"], cfg["head_dim"], cfg["window"]
    base = [torch.randn((b, h, s, d), dtype=torch.float64, device="cuda",
                        generator=gen)
            for h in (cfg["hq"], cfg["hkv"], cfg["hkv"])]
    g = cfg["hq"] // cfg["hkv"]
    pos = torch.arange(s, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)

    def time_ms(fn) -> float:
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    out: dict = {"times": {}, "sdpa_max_abs_diff": {},
                 "plain_max_abs_diff": {}, "ptxas": _k5_ptxas(root)}
    for dtype in (torch.float16, torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        if only and not any(sub in name for sub in only.split(",")):
            continue
        q, k, v = (x.to(dtype) for x in base)
        for cap in (cfg["softcap"], None):
            out["times"][f"K5 {name} softcap {cap}"] = time_ms(
                lambda cap=cap: kswa.sliding_window_attention(
                    q, k, v, w, cfg["tq"], cap))
        kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)

        def sdpa():
            return F.scaled_dot_product_attention(q, kk, vv, attn_mask=band)
        out["times"][f"SDPA {name} band mask"] = time_ms(sdpa)
        out["sdpa_max_abs_diff"][name] = (
            sdpa().float() - kswa.sliding_window_attention(
                q, k, v, w, cfg["tq"], None).float()).abs().max().item()
        del kk, vv
        torch.cuda.empty_cache()
        out["plain_max_abs_diff"][name] = (
            kswa.sliding_window_attention(q, k, v, w, cfg["tq"],
                                          cfg["softcap"]).double()
            - kswa.sliding_window_attention_plain(
                q, k, v, w, cfg["tq"], cfg["softcap"]).double()
        ).abs().max().item()
        del q, k, v
        torch.cuda.empty_cache()
    return out


#: split_tf32's body in csrc/swa_tf32.cu per variant (--split-variants)
SPLIT_VARIANTS = {
    "rna-small": """  big = __float_as_uint(x);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small)
      : "f"(x - __uint_as_float(big & 0xffffe000u)));""",
    "rna": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));""",
}


def split_variant_roots() -> list[str]:
    """Copies of this checkout's ``src`` with swa_tf32.cu's split
    replaced, one per :data:`SPLIT_VARIANTS` entry."""
    import re
    import shutil
    roots = []
    for name, body in SPLIT_VARIANTS.items():
        root = os.path.join(ROOT, "build", "swa_variants", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src"), os.path.join(root, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(root, "src", "repro_torch", "kernels", "csrc",
                            "swa_tf32.cu")
        with open(path) as fh:
            text = fh.read()
        new, n = re.subn(
            r"(void split_tf32\(float x, uint32_t& big, uint32_t& small\) \{\n)"
            r".*?(\n\})", lambda m: m.group(1) + body + m.group(2), text,
            count=1, flags=re.S)
        if n != 1:
            raise RuntimeError(f"split_tf32 not found in {path}")
        with open(path, "w") as fh:
            fh.write(new)
        roots.append(root)
    return roots


def _k5_ptxas(root: str) -> dict:
    """Registers, spill bytes and stack frame of each K5 kernel instance,
    from nvcc's output for the checkout at ``root`` (its build, or the
    log kept beside a library built earlier)."""
    import re
    from repro_torch.kernels import _build
    _build.build_all()
    out, name = {}, None
    for src, text in sorted(_build.BUILD_LOGS.items()):
        if not src.startswith("swa"):
            continue
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = f"{src} {m.group(1)}"
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and name:
                out.setdefault(name, {}).update(
                    stack=int(m.group(1)), spill_stores=int(m.group(2)),
                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def tf32_reads() -> dict:
    """What ``mma.sync ... .tf32`` makes of f32 bits below tf32's 10
    mantissa bits, for each operand."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    src = os.path.join(ROOT, "tools", "tf32_probe.cu")
    lib_path = _build.build_dir() / "libtf32_probe.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(lib_path), src]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.tf32_probe_mma.argtypes = [ctypes.c_void_p] * 4
    lib.tf32_probe_mma.restype = ctypes.c_int
    u = 2.0 ** -10     # one tf32 ulp at 1
    values = [1 + u / 2 + u / 4,      # above half an ulp
              1 + u / 2,              # a tie, even neighbour below
              1 + u + u / 2,          # a tie, odd neighbour below
              1 + u / 4,              # below half an ulp
              1 + u / 2 + 2.0 ** -23,  # just above half
              1 + u - 2.0 ** -23,     # just below the next tf32 value
              -(1 + u / 2 + u / 4), -(1 + u / 2)]
    modes = {"truncate": lambda x: _tf32(x, "trunc"),
             "nearest, ties away": lambda x: _tf32(x, "rna"),
             "nearest, ties even": lambda x: _tf32(x, "rne"),
             "full f32": lambda x: x}
    res = {}
    for operand in ("a", "b"):
        a = torch.zeros(16, 8, dtype=torch.float32, device="cuda")
        b = torch.zeros(8, 8, dtype=torch.float32, device="cuda")
        if operand == "a":   # A[r][0] = value r, B[0][:] = 1
            a[:len(values), 0] = torch.tensor(values)
            b[0, :] = 1.0
        else:                # A[:][0] = 1, B[0][n] = value n
            a[:, 0] = 1.0
            b[0, :len(values)] = torch.tensor(values)
        d = torch.empty(16, 8, dtype=torch.float32, device="cuda")
        err = lib.tf32_probe_mma(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"tf32 probe launch failed: {err}")
        read = (d[:len(values), 0] if operand == "a"
                else d[0, :len(values)]).tolist()
        xs = torch.tensor(values, dtype=torch.float32).tolist()
        res[operand] = {
            "values": xs, "read": read,
            "matches": [m for m, f in modes.items()
                        if all(f(x) == r for x, r in zip(xs, read))]}
    lib.tf32_probe_rate.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.tf32_probe_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 4 * sms, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for _ in range(6):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        err = lib.tf32_probe_rate(out.data_ptr(), blocks, threads, iters,
                                  stream)
        e1.record()
        e1.synchronize()
        if err:
            raise RuntimeError(f"tf32 rate launch failed: {err}")
        times.append(e0.elapsed_time(e1))
    ms = statistics.median(times[1:])
    flop = blocks * threads // 32 * iters * 8 * 2 * 16 * 8 * 8
    res["mma_sync_rate"] = {"blocks": blocks, "threads": threads,
                            "iters": iters, "ms": ms,
                            "tflops": flop / ms / 1e9}
    return res


def _tf32(x: float, mode: str) -> float:
    """``x`` (an f32 value) to tf32 by ``mode`` on its bits."""
    import numpy as np
    bits = int(np.float32(x).view(np.uint32))
    low = bits & 0x1FFF
    if mode == "rna":
        bits += 0x1000
    elif mode == "rne" and (low > 0x1000 or (low == 0x1000
                                              and bits & 0x2000)):
        bits += 0x2000
    return float(np.uint32(bits & 0xFFFFE000).view(np.float32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--only", help="dtypes to time (float16,float32,...)")
    ap.add_argument("--split-variants", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.child, args.reps, args.only)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("swa_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi} | shape {GEMMA2_LOCAL}", flush=True)
    reads = tf32_reads()
    for operand in ("a", "b"):
        r = reads[operand]
        print(f"tf32 operand {operand}: {r['values']} read as {r['read']}: "
              f"{r['matches']}", flush=True)
    rate = reads["mma_sync_rate"]
    print(f"mma.sync.m16n8k8 tf32 alone: {rate['tflops']:.1f} TFLOP/s "
          f"({rate})", flush=True)
    roots = [os.path.abspath(r) for r in (args.root or [ROOT])]
    if args.split_variants:
        roots += split_variant_roots()
    runs = []
    for rnd in range(args.rounds):
        for root in roots:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--reps", str(args.reps)]
                + (["--only", args.only] if args.only else []),
                capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for label, ms in res["times"].items():
                print(f"round {rnd} {os.path.basename(root):12s} "
                      f"{label:32s} {ms:9.4f} ms", flush=True)
            print(f"round {rnd} {os.path.basename(root)} max |SDPA - K5| "
                  f"(softcap off): {res['sdpa_max_abs_diff']}; max |K5 - "
                  f"plain|: {res['plain_max_abs_diff']}", flush=True)
            if rnd == 0:
                for fn, info in res["ptxas"].items():
                    print(f"ptxas {os.path.basename(root)} {fn}: {info}",
                          flush=True)
            runs.append({"root": root, "round": rnd, **res})
    line = json.dumps({"card": smi, "reps": args.reps, "tf32_reads": reads,
                       "runs": runs})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
