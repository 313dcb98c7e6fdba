"""``repro_torch`` stands alone: no JAX, no ``repro``, no ``triton``.

Importing the port must load neither ``jax`` nor any ``repro`` module
and must not need ``triton`` or ``nvcc`` (kernels are built at first
use); a subprocess with those imports blocked runs a stencil and both
paper pipelines through ``CasperEngine`` and sliding-window attention
through ``kernels.ops.swa``, and an AST scan of the package's sources
and of ``chip_smoke.py`` finds no such import.
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
        if top in ("jax", "jaxlib", "repro", "triton"):
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
q, kv = torch.ones(1, 4, 50, 16), torch.ones(1, 2, 50, 16)
assert ops.swa(q, kv, kv, window=8, tq=32, softcap=50.0).shape == q.shape
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton")]
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
    files = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) >= 10
    assert PORT / "kernels" / "swa.py" in files
    assert PORT / "kernels" / "ops.py" in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for mod in _imports(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
