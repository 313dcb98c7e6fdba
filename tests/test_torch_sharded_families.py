"""The port's MoE dispatch and its other families on a (2, 2) mesh,
against the reference's single-device values.

Four gloo CPU ranks (``tests/_lm_world.py``, suite ``families``) run
olmoe with ``MoeCfg.dispatch="ep"`` and ``"local"``, and zamba2, xLSTM
and Whisper: a prefill over 12 tokens and one decode step each, in
float32 with float32 caches (attention K/V and Mamba2's conv state), from
the reference's init (its zero-initialized leaves drawn, as
``tests/_lm_reference.py`` draws them).  Every logit is held within 1e-4
of the reference's jitted single-device run, the float32 logits gate of
``tests/_lm_reference.py``; the two dispatches within 1e-4 of each other.
"""
import importlib.util
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _lm_reference import JCTX, _reference_init, f32_caches
from repro.configs import get_config as jget_config
from repro.models import make_arch as jmake_arch

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


dw = _load("_dist_world")
lw = _load("_lm_world")

F32_LOGITS = 1e-4
ARCHS = sorted({a for _, a, _ in lw.TRAIN_SERVE})


def _serve_reference(arch_id, tree):
    import repro.models.transformer as jtf
    jcfg = jget_config(arch_id, reduced=True)
    jarch = jmake_arch(jcfg)
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    batch = lw.inputs(jcfg, lw.SERVE_ROWS, lw.SERVE_SEQ + lw.DECODE_STEPS,
                      lw.SERVE_SEED)
    toks = batch["tokens"]
    prompt = {k: jnp.asarray(v) for k, v in batch.items()}
    prompt["tokens"] = jnp.asarray(toks[:, :lw.SERVE_SEQ])
    saved = jtf.init_caches.__defaults__
    jtf.init_caches.__defaults__ = (jnp.float32,)
    try:
        with f32_caches():
            st, n, lg = jax.jit(lambda p_, b_: jarch.prefill(
                p_, b_, jcfg, JCTX, max_len=lw.MAX_LEN))(p, prompt)
            out = {"prefill": np.asarray(lg, np.float32)}
            t = jnp.asarray(toks[:, lw.SERVE_SEQ:lw.SERVE_SEQ + 1])
            _, _, lg = jax.jit(lambda p_, s_, n_, t_: jarch.decode(
                p_, s_, n_, t_, jcfg, JCTX))(p, st, n, t)
            out["decode0"] = np.asarray(lg, np.float32)
    finally:
        jtf.init_caches.__defaults__ = saved
    return out


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("families_world"))
    trees = {}
    for a in ARCHS:
        _, _, trees[a] = _reference_init(a, "f32")
        lw.write_params(os.path.join(out, f"params_{a}.npz"), trees[a])
    box = {}

    def run():
        try:
            box["records"] = dw.run_world("families", 4, out, timeout=900,
                                          script=lw.SCRIPT)
        except BaseException as e:      # re-raised in the test
            box["error"] = e
    th = threading.Thread(target=run)
    th.start()
    ref = {a: _serve_reference(a, trees[a]) for a in ARCHS}
    th.join()
    if "error" in box:
        raise box["error"]

    def result(key):
        with np.load(os.path.join(out, key.replace("/", "__") + ".npz")) as f:
            return {k: f[k] for k in f.files}
    return {"ref": ref, "result": result}


@pytest.mark.parametrize("key,arch", [(k, a) for k, a, _ in lw.TRAIN_SERVE])
def test_sharded_serving_matches_single_device(fam, key, arch):
    want, got = fam["ref"][arch], fam["result"](key)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = float(np.abs(got[k] - want[k]).max())
        assert err < F32_LOGITS, (k, err)


def test_moe_dispatches_agree(fam):
    ep, local = fam["result"]("moe/ep"), fam["result"]("moe/local")
    for k in ep:
        assert float(np.abs(ep[k] - local[k]).max()) < F32_LOGITS, k
