"""Probe builds of the stencil kernel K1-K4 (``csrc/stencil.cu``) on one GPU.

    python3 tools/stencil_probe.py --root DIR [--out FILE]

``DIR`` is the root of a checkout whose ``src/repro_torch`` holds the
kernel to probe: the per-point-decode kernel of git commit 3401232
(unpack it with ``git archive 3401232 | tar -x -C DIR``).  The script
copies that checkout's ``stencil.cu`` into ``DIR/build/probe/`` and builds
it four times with ``-D`` switches patched into the copy (the checkout's
own source is not changed):

* ``base``: the source as it is;
* ``a``: the ghost restoration skipped (no fill test, no reflect passes;
  wrong results, timed only);
* ``b``: every per-point ``/`` and ``%`` decode of a linear index
  replaced by an incremental 2-D mapping with deltas computed once per
  loop (the same points, the same sums);
* ``ab``: both.

Each build is swapped in as the library behind ``kernels.engine`` and
timed with CUDA events (median) on K3 (reaction_diffusion2d, reflect,
8192^2) and K1 (jacobi2d, zero, 8192^2), f64, sweeps=4.  It also prints
``-Xptxas -v`` (registers, spills, shared memory) per kernel instance and
a ``cuobjdump -sass`` opcode count of the f64 instance.  The last line
is one JSON object with every number; ``--out`` writes it to a file too.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

# every per-point decode of a flat index i over a box (.., e1, e2)
_DECODE = re.compile(
    r"( *)for \(int i = threadIdx\.x; i < (\w+); i \+= blockDim\.x\) \{\n"
    r" *const int (\w)2 = i % (\w+)\[2\];\n"
    r" *const int r = i / \4\[2\];\n"
    r" *const int \3\s?1 = r % \4\[1\];\n"
    r" *const int \3\s?0 = r / \4\[1\];\n")


def _decode_2d(m: re.Match) -> str:
    ind, n, x, e = m.group(1), m.group(2), m.group(3), m.group(4)
    return (f"#ifdef PROBE_2D\n{ind}PROBE_LOOP(i, {n}, {e}[1], {e}[2], {x}0, "
            f"{x}1, {x}2) {{\n#else\n{m.group(0)}#endif\n")


# i walks the flat index as before; (x0, x1, x2) follow it by adding
# the per-stride deltas, carrying into the next dim -- no division
_LOOP_MACRO = r"""
#ifdef PROBE_2D
#define PROBE_LOOP(i, n, e1, e2, x0, x1, x2)                                  \
  for (int i = threadIdx.x, x2 = threadIdx.x % (e2),                          \
           x1 = (threadIdx.x / (e2)) % (e1), x0 = threadIdx.x / (e2) / (e1),  \
           _d2 = blockDim.x % (e2), _d1 = (blockDim.x / (e2)) % (e1),         \
           _d0 = blockDim.x / (e2) / (e1);                                    \
       i < (n); i += blockDim.x, x2 += _d2, x1 += _d1, x0 += _d0,             \
           x1 += (x2 >= (e2)), x2 -= (x2 >= (e2)) ? (e2) : 0,                 \
           x0 += (x1 >= (e1)), x1 -= (x1 >= (e1)) ? (e1) : 0)
#endif
"""
_PATCHES = [
    ('#define CASPER_THREADS 256\n', '#define CASPER_THREADS 256\n' + _LOOP_MACRO, 1),
    ("      if (nx.mode == MODE_REFLECT) {",
     "      if (nx.mode == MODE_REFLECT && !PROBE_NO_RESTORE) {", 1),
    ("        if (fill_mode) {", "        if (fill_mode && !PROBE_NO_RESTORE) {", 1),
]
VARIANTS = {"base": [], "a": ["-DPROBE_NO_RESTORE=1"], "b": ["-DPROBE_2D"],
            "ab": ["-DPROBE_NO_RESTORE=1", "-DPROBE_2D"]}


def patched(text: str) -> str:
    for old, new, count in _PATCHES:
        if text.count(old) != count:
            raise SystemExit(f"probe: fragment not found {count}x: {old!r}")
        text = text.replace(old, new)
    text, n = _DECODE.subn(_decode_2d, text)
    if n != 4:
        raise SystemExit(f"probe: {n} per-point decodes found, expected 4")
    return "#ifndef PROBE_NO_RESTORE\n#define PROBE_NO_RESTORE 0\n#endif\n" + text


def sass_counts(lib: str, cuobjdump: str) -> dict:
    """Opcode counts of the f64 instance of casper_chain_kernel."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "casper_chain_kernelIdE" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1).split(".")[0]] += 1
    keys = ("IMAD", "IADD3", "I2F", "F2I", "MUFU", "ISETP", "LDS", "STS", "LDG",
            "DMUL", "DADD", "BAR", "BRA")
    return {"total": sum(counts.values()), **{k: counts.get(k, 0) for k in keys}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("stencil_probe: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import PAPER_PIPELINES, PAPER_STENCILS
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine as keng

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    src = os.path.join(root, "src", "repro_torch", "kernels", "csrc", "stencil.cu")
    out_dir = os.path.join(root, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    probe_src = os.path.join(out_dir, "stencil_probe.cu")
    with open(src) as fh:
        text = patched(fh.read())
    with open(probe_src, "w") as fh:
        fh.write(text)
    nvcc = _build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    jobs = {}
    for name, flags in VARIANTS.items():
        lib = os.path.join(out_dir, f"libstencil_{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", lib, probe_src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    result = {"card": smi, "torch": torch.__version__, "variants": {}}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        result["variants"][name] = {"ptxas": ptxas,
                                    "sass_f64": sass_counts(lib, cuobjdump)}
        print(f"{name}: sass f64 {result['variants'][name]['sass_f64']}", flush=True)
        for ln in ptxas:
            print(f"  {name}: {ln}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(20211228)
    g = torch.randn((8192, 8192), dtype=torch.float64, device="cuda", generator=gen)
    cases = {"K3 reaction_diffusion2d reflect 8192^2":
             (keng.pipeline_sweep, PAPER_PIPELINES["reaction_diffusion2d"]),
             "K1 jacobi2d zero 8192^2": (keng.stencil_sweep, PAPER_STENCILS["jacobi2d"])}

    def time_ms(fn) -> list:
        for _ in range(2):
            fn()
        out = []
        for _ in range(args.reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return out

    base_out = {}
    for name, (lib, _) in jobs.items():
        cdll = ctypes.CDLL(lib)
        _build._LIBS[keng.SOURCE] = cdll
        for label, (fn, spec) in cases.items():
            run = lambda: fn(spec, g, None, 4, "pad-free")  # noqa: E731
            got = run()
            torch.cuda.synchronize()
            if name == "base":
                base_out[label] = got
            equal = bool(torch.equal(got, base_out[label]))
            times = time_ms(run)
            result["variants"][name][label] = {
                "ms_median": statistics.median(times), "ms_min": min(times),
                "ms_max": max(times), "equal_to_base": equal}
            print(f"{name:4s} {label}: median {statistics.median(times):.4f} ms "
                  f"(min {min(times):.4f}, max {max(times):.4f}), equal to base "
                  f"{equal}", flush=True)
            del got
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
