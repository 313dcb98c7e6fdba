"""The port's checkpoints (``repro_torch.checkpointing``) against the
reference's on-disk format.

* a round trip of bf16, f32, int8 and int32 leaves, tuples and 0-d
  leaves among them, bitwise;
* a step without ``COMMIT`` is skipped; ``keep`` retention; a checksum
  mismatch raises; a missing leaf and a shape mismatch raise;
* for the same tree both packages write the same manifest (paths,
  shapes, dtypes, checksums) and the same arrays; a checkpoint the
  reference writes restores in the port, one the port writes restores in
  the reference, both bitwise, the reference's quantized optimizer state
  among them.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_checkpoint as jrestore
from repro.checkpointing import save_checkpoint as jsave
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch import params_from_reference
from repro_torch.checkpointing import (CheckpointManager, latest_step,
                                       restore_checkpoint, save_checkpoint)
from repro_torch.models.common import tree_leaves


def _numpy_tree(rng):
    """bf16 (as float32 values), f32, int8, int32, a 0-d leaf and a
    tuple, in dicts."""
    return {
        "params": {"embed": rng.standard_normal((4, 6)).astype(np.float32),
                   "units": {"w": rng.standard_normal((2, 3, 5))
                             .astype(np.float32)}},
        "opt": {"step": np.asarray(7, np.int32),
                "q": rng.integers(-127, 128, (3, 256)).astype(np.int8),
                "scale": rng.random((3, 1)).astype(np.float32)},
        "state": (rng.standard_normal((2, 2)).astype(np.float32),
                  np.arange(5, dtype=np.int32)),
    }


def _jax_tree(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["params"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                 out["params"])
    return out


def _torch_tree(jtree):
    return params_from_reference(jax.tree.map(np.asarray, jtree),
                                 device="cpu")


def _assert_bitwise(tt, jt):
    got = list(tree_leaves(tt, torch.is_tensor))
    want = jax.tree.leaves(jt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert list(g.shape) == list(w.shape)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_round_trip_bitwise(tmp_path, rng):
    tree = _torch_tree(_jax_tree(_numpy_tree(rng)))
    save_checkpoint(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 3
    got = restore_checkpoint(str(tmp_path), 3, tree)
    for a, b in zip(tree_leaves(got, torch.is_tensor),
                    tree_leaves(tree, torch.is_tensor)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert isinstance(got["state"], tuple)
    assert got["opt"]["step"].shape == ()


def test_restore_casts_to_like(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    save_checkpoint(str(tmp_path), 1, tree)
    like = {"a": torch.zeros((2, 3), dtype=torch.float64)}
    got = restore_checkpoint(str(tmp_path), 1, like)
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], tree["a"].double())


def test_partial_checkpoint_is_skipped(tmp_path):
    tree = {"a": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    # a torn write: step 2 loses its COMMIT marker
    os.remove(os.path.join(str(tmp_path), "step_00000002", "COMMIT"))
    assert latest_step(str(tmp_path)) == 1
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert latest_step(str(tmp_path)) == 1
    step, _ = CheckpointManager(str(tmp_path)).restore_latest(tree)
    assert step == 1


def test_corrupt_checkpoint_detected(tmp_path):
    tree = {"a": torch.arange(256, dtype=torch.float32)}
    d = save_checkpoint(str(tmp_path), 1, tree)
    np.savez(os.path.join(d, "shard_0.npz"), leaf_0=np.zeros(256, np.float32))
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), 1, tree)
    # verify=False reads it as it is
    got = restore_checkpoint(str(tmp_path), 1, tree, verify=False)
    assert not got["a"].any()


def test_missing_leaf_and_shape_mismatch_raise(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), 1, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(4)})


def test_manager_retention_and_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        tree["a"] += 1                 # the save holds its own copy
        mgr.save_async(s, tree)
    mgr.wait()
    steps = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    step, got = mgr.restore_latest(tree)
    assert step == 4 and torch.equal(got["a"], torch.full((2,), 4.0))


def test_shards_split_at_the_byte_cap(tmp_path, monkeypatch):
    import repro_torch.checkpointing.ckpt as tckpt
    monkeypatch.setattr(tckpt, "_SHARD_BYTES", 64)
    tree = {k: torch.arange(16, dtype=torch.float32) + i
            for i, k in enumerate("abc")}
    d = save_checkpoint(str(tmp_path), 5, tree)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["files"] == ["shard_0.npz", "shard_1.npz",
                                 "shard_2.npz"]
    got = restore_checkpoint(str(tmp_path), 5, tree)
    assert all(torch.equal(got[k], tree[k]) for k in tree)


def test_same_files_as_the_reference(tmp_path, rng):
    jtree = _jax_tree(_numpy_tree(rng))
    jd = jsave(str(tmp_path / "ref"), 2, jtree)
    td = save_checkpoint(str(tmp_path / "port"), 2, _torch_tree(jtree))
    manifests = []
    for d in (jd, td):
        assert sorted(os.listdir(d)) == ["COMMIT", "manifest.json",
                                         "shard_0.npz"]
        with open(os.path.join(d, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    paths = [e["path"] for e in manifests[1]["leaves"]]
    assert paths[:2] == ["['opt']['q']", "['opt']['scale']"]
    assert "['state'][1]" in paths
    assert {e["dtype"] for e in manifests[1]["leaves"]} == {
        "bfloat16", "float32", "int8", "int32"}
    ja, ta = (np.load(os.path.join(d, "shard_0.npz")) for d in (jd, td))
    for k in ja.files:
        assert ja[k].dtype == ta[k].dtype          # bf16 as |V2 in both
        assert ja[k].tobytes() == ta[k].tobytes()


def test_reference_checkpoint_restores_in_port(tmp_path, rng):
    jtree = _jax_tree(_numpy_tree(rng))
    jsave(str(tmp_path), 4, jtree)
    like = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, jtree))
    got = restore_checkpoint(str(tmp_path), 4,
                             params_from_reference(like, device="cpu"))
    _assert_bitwise(got, jtree)


def test_port_checkpoint_restores_in_reference(tmp_path, rng):
    jtree = _jax_tree(_numpy_tree(rng))
    save_checkpoint(str(tmp_path), 4, _torch_tree(jtree))
    got = jrestore(str(tmp_path), 4, jtree)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("quant", [False, True])
def test_optimizer_state_crosses_both_ways(tmp_path, rng, quant):
    params = {"w": jnp.asarray(rng.standard_normal((3, 300)),
                               jnp.bfloat16),
              "b": jnp.asarray(rng.standard_normal((5,)), jnp.float32)}
    jtree = {"params": params,
             "opt": jinit_opt_state(params, JAdamWConfig(
                 quantize_state=quant))}
    jsave(str(tmp_path / "ref"), 1, jtree)
    ttree = _torch_tree(jtree)
    got = restore_checkpoint(str(tmp_path / "ref"), 1, ttree)
    _assert_bitwise(got, jtree)
    save_checkpoint(str(tmp_path / "port"), 1, got)
    back = jrestore(str(tmp_path / "port"), 1, jtree)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
