"""The recurrences' training steps are linear in the sequence on a mesh.

xLSTM's sLSTM steps token by token and its mLSTM, like Mamba2's SSD,
chunk by chunk.  Each loop takes its per-step (per-chunk) inputs from
one ``unbind``, whose backward stacks the grads once; a ``select`` per
step would write a zero tensor of the whole sequence per step, and a
training step's bytes and peak would grow with the square of the
sequence (the dry run read 4,730 GiB a device for xlstm-125m's
``train_4k`` on 16x16 before).  Here the step of the reduced xLSTM (two
layers, one of them sLSTM) is traced on a fake 16x16 world
(``launch.dryrun.trace_lm``, 32 rows) at 16, 32, 64 and 128 tokens, and
the walk's liveness peak and bytes a device must grow by at most 2.3x
per doubling (linear: 2x, less what does not scale with the sequence;
a whole-sequence grad per step read 2.16x, 2.39x and 2.69x).
``tests/test_torch_recurrence_linear_ssd.py`` holds zamba2 the same
way.
"""
import importlib.util
import os

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.optim import AdamWConfig
from repro_torch.roofline import graph_walk

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "_dryrun_sweep", os.path.join(HERE, "_dryrun_sweep.py"))
sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep)

SEQS = (16, 32, 64, 128)
ROWS = 32
GROWTH = 2.3


def growth(arch: str, seqs) -> dict:
    """Per doubling of the sequence, the growth of the traced training
    step's liveness peak and of its bytes, a device of a fake 16x16
    world, for ``arch`` reduced as the sweep reduces it."""
    mesh = dryrun.fake_mesh(production_mesh_shape(multi_pod=False))
    cfg = sweep.shrink(get_config(arch))
    peaks, moved = [], []
    for s in seqs:
        with dryrun.traceable_dtensor():
            gm = dryrun.trace_lm(cfg, "train", mesh, ROWS, s,
                                 opt_cfg=AdamWConfig())
        t = graph_walk.walk(gm, mesh.size())
        peaks.append(t.memory["peak_bytes"])
        moved.append(t.bytes)
    return {name: [b / a for a, b in zip(v, v[1:])]
            for name, v in (("peak", peaks), ("bytes", moved))}


@pytest.fixture(scope="module", autouse=True)
def _fake_world_torn_down():
    yield
    dryrun.end_fake_world()


def test_xlstm_training_step_grows_linearly():
    for name, g in growth("xlstm-125m", SEQS).items():
        assert max(g) <= GROWTH, (name, g)
