"""The dry run's extensions (``repro_torch.launch.dryrun``) against
whole traces, on a fake world of 256 ranks:

* depth: a transformer traced at one and two units and carried to four
  gives the four-unit trace's FLOPs, collectives and memory split, and
  its bytes within 1e-6, whatever worlds the process held before
  (``dryrun.end_fake_world`` clears DTensor's caches, whose plans would
  carry an old world's meshes);
* sequence: xLSTM traced at three sequence lengths and carried to a
  longer one along a quadratic gives that trace's totals.

The fake world is this process's and is torn down when the module ends.
"""
import dataclasses

import pytest

from repro_torch.launch import dryrun


@pytest.fixture(scope="module", autouse=True)
def _fake_world_torn_down():
    yield
    dryrun.end_fake_world()


def test_depth_extension_equals_the_deeper_trace():
    def four(cfg):
        return dataclasses.replace(cfg.reduced(), n_layers=4 * cfg.unit)
    ext = dryrun.lower_cell("qwen3-14b", "train_4k", False, shrink=four)
    full = dryrun.lower_cell("qwen3-14b", "train_4k", False, shrink=four,
                             full_depth=True)
    assert ext["traced_depths"] == [1, 2] and ext["repeats"] == 3
    assert full["traced_depths"] == [4]
    for k in ("flops_per_device", "memory", "collective_ops",
              "collective_bytes_per_device"):
        assert ext[k] == full[k], k
    # one op's bytes are not affine in depth: 49,152 B of 5.3e11
    assert ext["bytes_per_device"] == pytest.approx(
        full["bytes_per_device"], rel=1e-6)


def test_sequence_extension_equals_the_longer_trace(monkeypatch):
    """xLSTM on three sequence lengths carried to a longer one along a
    quadratic equals its trace at that length (here four base lengths,
    where the sweep waits for twelve; a base of 32: two positions a
    rank of the 16-way "model" axis)."""
    monkeypatch.setattr(dryrun, "SEQ_EXTEND_MIN", 4)
    small = dataclasses.replace(dryrun.CELLS["train_4k"], seq_len=128,
                                global_batch=32)

    def tiny(cfg):
        r = cfg.reduced()
        return dataclasses.replace(r, n_layers=1, slstm_layers=(0,),
                                   ssm=dataclasses.replace(r.ssm, chunk=1))
    ext = dryrun.lower_cell("xlstm-125m", "train_4k", False, shrink=tiny,
                            cell=small)
    full = dryrun.lower_cell("xlstm-125m", "train_4k", False, shrink=tiny,
                             cell=small, full_depth=True)
    assert ext["traced_seq_lens"] == [32, 64, 96]
    assert full["traced_seq_lens"] == [128]
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device"):
        assert ext[k] == pytest.approx(full[k], rel=1e-9), k
    for k, v in full["memory"].items():
        assert ext["memory"][k] == pytest.approx(v, rel=1e-9), k
