"""The port's sharded LM paths against the reference's single-device values.

Eight gloo CPU ranks (``tests/_lm_world.py``, suite ``lm``) carry the
reference's reduced yi-9b init onto DTensor meshes and run one AdamW
step and serving (prefill, then teacher-forced decode steps): ranks 0-3
on (2, 2) and (4, 1) while ranks 4-7 run (1, 4), then all eight on the
(2, 2, 2) pod mesh.  The reference cannot run sharded on this host (its
sharded tests stop at the embedding gather under jax 0.9), so each run is
held against the reference's single-device jitted step and serving on
the same numpy params and batch, as the reference's own tests hold
sharded against single-device:

* float32: the loss and grad norm within 1e-5 relative; each first
  moment m = (1 - b1) * clip * g within 1e-4 of its leaf's largest entry
  (``_lm_reference.assert_step_matches``' rule); each leaf's change
  from the init within 1e-2 of the reference's change, in norm (Adam's
  first step moves an entry by about lr * sign(g); a step that never
  wrote its update back reads 1, one that added it 2; the few entries
  whose g sits at Adam's eps move apart by up to a sixth of the largest
  change: in norm 1.8e-3 at most on a first run); logits within 1e-4,
  with the KV caches in float32 on both sides (a bfloat16 cache rounds
  K/V that differ in their last bits);
* bfloat16: the loss within 5e-3 and the params within 5e-2
  (``tests/test_distributed.py``'s sharded train-step gates), the
  logits within 0.5 (its flash-decode gate against one device);
* flash-decode (KV sequence over ``model``) against dense decode on the
  same (1, 4) mesh within 1e-3, as the reference's test holds it.
"""
import importlib.util
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _lm_reference import JCTX, TRAIN_FLOOR, _reference_init
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dw = _load("_dist_world")
lw = _load("_lm_world")

ARCH = "yi-9b"
F32_LOGITS = 1e-4
F32_M_RTOL = 1e-4
BF16_LOSS, BF16_PARAMS, BF16_LOGITS = 5e-3, 5e-2, 0.5
FLASH_VS_DENSE = 1e-3
CHANGE_RTOL = 1e-2


def _f32_caches(jtransformer, on: bool):
    saved = jtransformer.init_caches.__defaults__
    if on:
        jtransformer.init_caches.__defaults__ = (jnp.float32,)
    return saved


def _reference(jcfg, jarch, tree):
    """The reference's single-device values: a jitted train step and
    jitted serving in f32 (f32 caches) and bf16."""
    import repro.models.transformer as jtf
    out = {}
    batch = lw.inputs(jcfg, lw.TRAIN_ROWS, lw.TRAIN_SEQ, lw.TRAIN_SEED)
    opt = JAdamWConfig(**lw.TRAIN_OPT)
    step = jax.jit(jmake_train_step(jarch, opt, JCTX))
    for dtype, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        p = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
        newp, st, met = step(p, jinit_opt_state(p, opt),
                             {"tokens": jnp.asarray(batch["tokens"])})
        out[f"train/{dtype}"] = {
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "params": jax.tree.map(np.asarray, newp),
            "m": jax.tree.map(np.asarray, st["m"])}
    toks = lw.inputs(jcfg, lw.SERVE_ROWS, lw.SERVE_SEQ + lw.DECODE_STEPS,
                     lw.SERVE_SEED)["tokens"]
    for dtype, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        p = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
        saved = _f32_caches(jtf, dtype == "f32")
        try:
            pre = jax.jit(lambda p_, t_: jarch.prefill(
                p_, {"tokens": t_}, jcfg, JCTX, max_len=lw.MAX_LEN))
            dec = jax.jit(lambda p_, s_, n_, t_: jarch.decode(
                p_, s_, n_, t_, jcfg, JCTX))
            st, n, lg = pre(p, jnp.asarray(toks[:, :lw.SERVE_SEQ]))
            vals = {"prefill": np.asarray(lg, np.float32)}
            for i in range(lw.DECODE_STEPS):
                t = jnp.asarray(toks[:, lw.SERVE_SEQ + i:lw.SERVE_SEQ + i + 1])
                st, n, lg = dec(p, st, n, t)
                vals[f"decode{i}"] = np.asarray(lg, np.float32)
        finally:
            jtf.init_caches.__defaults__ = saved
        out[f"serve/{dtype}"] = vals
    return out


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The world's records and results beside the reference's values; the
    reference runs in this process while the ranks run."""
    out = str(tmp_path_factory.mktemp("lm_world"))
    jcfg, jarch, tree = _reference_init(ARCH, "f32")
    lw.write_params(os.path.join(out, f"params_{ARCH}.npz"), tree)
    box = {}

    def run():
        try:
            box["records"] = dw.run_world("lm", 8, out, timeout=900,
                                          script=lw.SCRIPT)
        except BaseException as e:      # re-raised in the test
            box["error"] = e
    th = threading.Thread(target=run)
    th.start()
    ref = _reference(jcfg, jarch, tree)
    th.join()
    if "error" in box:
        raise box["error"]

    def result(key):
        path = os.path.join(out, key.replace("/", "__") + ".npz")
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    return {"records": box["records"], "ref": ref, "result": result,
            "init": tree}


def _tree_close(want, got: dict, prefix: str, tol_of) -> float:
    """The largest |want - got| over the leaves; each within
    ``tol_of(leaf)``."""
    worst = 0.0
    for path, w in lw.keypaths(want):
        g = got[prefix + path]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= tol_of(w), (path, err, tol_of(w))
        worst = max(worst, err)
    return worst


def _change_close(want, got: dict, init) -> None:
    """Every leaf's change from ``init`` against the reference's."""
    inits = dict(lw.keypaths(init))
    for path, w in lw.keypaths(want):
        err = lw.change_gap(w, got["params" + path], inits[path])
        assert err <= CHANGE_RTOL, (path, err)


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1", "2x2x2"])
def test_sharded_train_step_f32(lm, mesh):
    want, got = lm["ref"]["train/f32"], lm["result"](f"train/f32/{mesh}")
    assert float(got["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(got["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                    rel=1e-5)
    floor = TRAIN_FLOOR * max(float(np.abs(np.asarray(x)).max())
                              for _, x in lw.keypaths(want["m"]))
    _tree_close(want["m"], got, "m",
                lambda w: F32_M_RTOL * float(np.abs(w).max()) + floor)
    _change_close(want["params"], got, lm["init"])


def test_sharded_train_step_bf16(lm):
    want, got = lm["ref"]["train/bf16"], lm["result"]("train/bf16/2x2")
    assert abs(float(got["loss"]) - want["loss"]) < BF16_LOSS
    _tree_close(want["params"], got, "params", lambda w: BF16_PARAMS)


@pytest.mark.parametrize("key", ["serve/f32/2x2", "serve/f32/1x4",
                                 "serve/f32/4x1", "serve/f32/2x2x2",
                                 "serve/f32/1x4+tponly", "flash/f32/1x4"])
def test_sharded_serving_f32(lm, key):
    want, got = lm["ref"]["serve/f32"], lm["result"](key)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert float(np.abs(got[k] - want[k]).max()) < F32_LOGITS, k


@pytest.mark.parametrize("key", ["serve/bf16/2x2", "dense/bf16/1x4",
                                 "flash/bf16/1x4"])
def test_sharded_serving_bf16(lm, key):
    want, got = lm["ref"]["serve/bf16"], lm["result"](key)
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) < BF16_LOGITS, k


def test_flash_decode_matches_dense_on_the_mesh(lm):
    dense = lm["result"]("dense/bf16/1x4")
    flash = lm["result"]("flash/bf16/1x4")
    # prefill takes the dense path in both; the decode steps take flash
    assert np.array_equal(dense["prefill"], flash["prefill"])
    for i in range(lw.DECODE_STEPS):
        err = float(np.abs(dense[f"decode{i}"] - flash[f"decode{i}"]).max())
        assert err < FLASH_VS_DENSE, (i, err)


def test_world_ran_every_case(lm):
    keys = [c[0] for half in lw.LM_HALVES for c in half] + [
        c[0] for c in lw.LM_POD]
    for key in keys:
        lm["result"](key)
    for rec in lm["records"]:
        assert all(ok for ok, _ in rec["checks"].values()), rec["checks"]


def test_pod_mesh_blocks_are_major_first(lm):
    # (8, 4) arange under P(("pod", "data"), "model") on (2, 2, 2): the
    # rank at (pod p, data d, model m) holds rows (2p + d) * 2 .. + 2 and
    # columns 2m .. 2m + 2, the block JAX gives it
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    seen = set()
    for rec in lm["records"]:
        b = rec["blocks"]["pod"]
        p, d, m = b["coord"]
        row = (2 * p + d) * 2
        want = full[row:row + 2, 2 * m:2 * m + 2]
        assert np.array_equal(np.asarray(b["local"], np.float32), want)
        seen.add((p, d, m))
    assert len(seen) == 8
