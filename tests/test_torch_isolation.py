"""``repro_torch`` stands alone: no JAX, no ``repro``, no ``triton``, no
``ml_dtypes``.

Importing the port must load neither ``jax`` nor any ``repro`` module
and must not need ``triton`` or ``nvcc`` (kernels are built at first
use); a subprocess with those imports blocked runs a stencil and both
paper pipelines through ``CasperEngine``, analyzes a plan
(``repro_torch.analysis``), serves the reference's mix
(``repro_torch.serve``), imports the distributed path
(``core/halo.py``), runs sliding-window attention through
``kernels.ops.swa`` and serves a reduced qwen3-14b (``configs``,
``models``, ``serve.ServeEngine``; ``roofline.analysis`` and
``sharding`` beside them) and reduced zamba2, xLSTM and Whisper, walks
a traced graph (``roofline.graph_walk``) and lowers a stencil and a
reduced decode cell on a fake 256-rank world (``launch.dryrun``), trains
a reduced qwen3-14b for two steps through the ``Trainer`` (``train``,
``optim`` with 8-bit state and gradient compression, ``checkpointing``
with bf16 leaves, ``data``) and resumes it, and an AST scan of the
package's sources
(the analysis, serving, halo and LM modules among them), of
``chip_smoke.py`` and of the helpers it loads from ``tests/`` finds no
such import.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_PROBE = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro", "triton", "ml_dtypes"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import repro_torch
from repro_torch import CasperEngine, PAPER_PIPELINES, PAPER_STENCILS
import torch
from repro_torch.kernels import engine, ops

spec = PAPER_STENCILS["jacobi2d"]
out = CasperEngine(spec, backend="cuda", device="cpu", sweeps=2).run(
    np.ones((40, 70)), iters=3)
assert out.shape == (40, 70)
for pipe in PAPER_PIPELINES.values():
    out = CasperEngine(pipe, backend="cuda", device="cpu", sweeps=2).run(
        np.ones((40, 70)), iters=3)
    assert out.shape == (40, 70)
from repro_torch import analysis, serve
from repro_torch.core import halo
assert callable(halo.distributed_stencil_fn)
plan = engine._plan.lower(spec, (40, 70), torch.float64, backend="cuda",
                          sweeps=2, device="cpu")
assert analysis.analyze_plan(plan).ok
srv = serve.StencilServer(backend="cuda", sweeps=2, device="cpu")
res, stats = srv.serve(serve.mixed_requests(8, seed=7, dtype=np.float64))
assert stats.n_buckets >= 1 and all(r.device.type == "cpu" for r in res)
q, kv = torch.ones(1, 4, 50, 16), torch.ones(1, 2, 50, 16)
assert ops.swa(q, kv, kv, window=8, tq=32, softcap=50.0).shape == q.shape
from repro_torch.configs import get_config
from repro_torch.models import make_arch
from repro_torch.models.common import init_params
from repro_torch.roofline.analysis import n_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import ShardCtx
cfg = get_config("qwen3-14b", reduced=True)
arch = make_arch(cfg)
params = init_params(torch.Generator().manual_seed(0), arch.param_specs(cfg),
                     device="cpu")
toks = ServeEngine(arch, params, max_len=16, device="cpu").generate(
    {"tokens": torch.zeros(2, 5, dtype=torch.int32)}, 2)
assert toks.shape == (2, 2) and n_params(cfg) > 0
for arch_id in ("zamba2-7b", "xlstm-125m", "whisper-tiny"):
    cfg = get_config(arch_id, reduced=True)
    arch = make_arch(cfg)
    params = init_params(torch.Generator().manual_seed(0),
                         arch.param_specs(cfg), device="cpu")
    batch = {"tokens": torch.zeros(2, 5, dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(2, 8, cfg.d_model, dtype=torch.bfloat16)
    toks = ServeEngine(arch, params, max_len=16, device="cpu").generate(
        batch, 2)
    assert toks.shape == (2, 2) and n_params(cfg) > 0
assert ShardCtx().constrain(toks) is toks
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
assert dryrun.cell_record("qwen3-14b", "decode_32k", False)["status"] == "ok"
assert production_mesh_shape(multi_pod=True).size == 512
from repro_torch.models.registry import ShapeCell
from repro_torch.roofline import graph_walk
assert graph_walk.walk_fn(lambda a, b: a @ b, torch.ones(4, 8),
                          torch.ones(8, 2)).flops == 128
assert dryrun.lower_stencil("jacobi2d", False)["status"] == "ok"
rec = dryrun.lower_cell("qwen3-14b", "decode_32k", False,
                        shrink=lambda c: c.reduced(),
                        cell=ShapeCell("decode_32k", 16, 32, "decode"))
assert rec["status"] == "ok" and rec["flops_per_device"] > 0
dryrun.end_fake_world()
import tempfile
from repro_torch.checkpointing import latest_step
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainLoopConfig
cfg = get_config("qwen3-14b", reduced=True)
with tempfile.TemporaryDirectory() as d:
    lc = TrainLoopConfig(total_steps=2, ckpt_every=1, ckpt_dir=d,
                         grad_compression=True)
    opt = AdamWConfig(quantize_state=True)
    hist = Trainer(make_arch(cfg), opt, lc, device="cpu").run()
    assert hist[-1]["step"] == 2 and latest_step(d) == 2
    tr = Trainer(make_arch(cfg), opt, lc, device="cpu")
    assert tr.try_resume() and tr.step == 2
    assert tr.params["embed"].dtype == torch.bfloat16
assert batch_for_step(DataConfig(vocab=9, seq_len=4, global_batch=2), 0,
                      "cpu")["tokens"].shape == (2, 4)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton",
                              "ml_dtypes")]
assert not bad, bad
print("isolated")
"""


def test_import_loads_no_jax_no_repro_no_triton():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_no_jax_and_no_repro():
    # chip_smoke.py and the helpers it loads from tests/
    files = sorted(PORT.rglob("*.py")) + [
        SRC.parent / "chip_smoke.py", SRC.parent / "tests" / "_dist_world.py",
        SRC.parent / "tests" / "_lm_world.py",
        SRC.parent / "tests" / "_lm_chip.py",
        SRC.parent / "tests" / "_dryrun_chip.py",
        SRC.parent / "tests" / "_pipeline_cases.py"]
    assert len(files) >= 10
    assert PORT / "kernels" / "swa.py" in files
    assert PORT / "kernels" / "ops.py" in files
    for mod in ("core/halo.py", "analysis/verify.py",
                "analysis/launch_lint.py",
                "analysis/serve_check.py", "analysis/casper_lint.py",
                "serve/stencil.py", "serve/scheduler.py", "serve/loadgen.py",
                "serve/engine.py", "sharding.py", "convert.py", "device.py",
                "roofline/analysis.py", "roofline/graph_walk.py",
                "configs/__init__.py",
                "configs/qwen3_14b.py", "models/attention.py",
                "models/common.py", "models/moe.py", "models/mlp.py",
                "models/transformer.py", "models/registry.py",
                "models/mamba2.py", "models/zamba2.py", "models/xlstm.py",
                "models/whisper.py", "optim/adamw.py", "optim/compress.py",
                "train/loop.py", "checkpointing/ckpt.py",
                "data/synthetic.py", "launch/__init__.py", "launch/mesh.py",
                "launch/dryrun.py"):
        assert PORT / mod in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for mod in _imports(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                (path, mod)
