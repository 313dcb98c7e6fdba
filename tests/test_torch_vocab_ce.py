"""The port's vocabulary-parallel cross entropy on gloo worlds against the
reference's ``cross_entropy``.

Four CPU ranks (``tests/_lm_world.py``, suite ``ce``) place the same
seeded float32 logits split over the vocabulary on (2, 2) and on (1, 4)
(``("dp", None, "tp")``, the constraint ``unembed`` gives them), with
labels in every block of the vocabulary, and take the loss and its grad
with respect to the logits, with the z-loss and a mask each on and off.
The test process computes the reference's ``cross_entropy`` and
``jax.grad`` of it on the same arrays, in float32.  The loss is held
within 1e-6 relative and the grad within 1e-6 of its largest entry: the
two differ only in the order of the sums over the vocabulary (a sum per
block, then a SUM all-reduce).  Each rank also checks that the grad kept
the vocabulary split.
"""
import importlib.util
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.common import cross_entropy as jcross_entropy

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dw = _load("_dist_world")
lw = _load("_lm_world")

F32_RTOL = 1e-6


def _reference(z_loss: bool, masked: bool):
    logits, labels, mask = lw.ce_inputs()

    def loss(x):
        return jcross_entropy(x, jnp.asarray(labels),
                              jnp.asarray(mask) if masked else None,
                              lw.CE_Z if z_loss else 0.0)
    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(logits))
    return float(value), np.asarray(grad)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ce_world"))
    box = {}

    def run():
        try:
            box["records"] = dw.run_world("ce", 4, out, timeout=300,
                                          script=lw.SCRIPT)
        except BaseException as e:      # re-raised in the test
            box["error"] = e
    th = threading.Thread(target=run)
    th.start()
    ref = {(z, mk): _reference(z, mk) for z in (False, True)
           for mk in (False, True)}
    th.join()
    if "error" in box:
        raise box["error"]

    def result(key):
        with np.load(os.path.join(out, key.replace("/", "__") + ".npz")) as f:
            return {k: f[k] for k in f.files}
    return {"ref": ref, "result": result, "records": box["records"]}


def test_labels_hit_every_block():
    _, labels, _ = lw.ce_inputs()
    assert set(labels.reshape(-1) * 4 // lw.CE_VOCAB) == {0, 1, 2, 3}


@pytest.mark.parametrize("key,shape,z_loss,masked", lw.CE_CASES)
def test_vocab_parallel_ce_matches_reference(world, key, shape, z_loss,
                                             masked):
    want_loss, want_grad = world["ref"][(z_loss, masked)]
    got = world["result"](key)
    assert float(got["loss"]) == pytest.approx(want_loss, rel=F32_RTOL)
    assert got["grad"].shape == want_grad.shape
    err = float(np.abs(got["grad"] - want_grad).max())
    assert err <= F32_RTOL * float(np.abs(want_grad).max()), err


def test_grad_stays_split_over_the_vocabulary(world):
    for rec in world["records"]:
        for name, (ok, detail) in rec["checks"].items():
            assert ok, (rec["rank"], name, detail)
