"""Sharded training steps of Whisper and xLSTM on a (2, 2) mesh against
the reference's single-device step.

Eight gloo CPU ranks (``tests/_lm_world.py``, suite ``recurrent``) take
one float32 AdamW step of each from the reference's reduced init at its
true fan-in (``tests/_lm_reference.py`` ``pair(..., fan_in=True)``, as
``tests/test_torch_train.py`` takes it on one device): on (2, 2) in
ranks 0-3, the batch over ``dp`` and the heads over ``model``, xLSTM's
mLSTM and sLSTM scans and Whisper's attention on each rank's blocks
(``sharding.local_map``), Whisper's tokens through the vocabulary-
parallel lookup; then xLSTM on (1, 8) over 8 rows, where its 4 heads do
not divide "model" and each rank scans one row
(``ShardCtx.scan_axes``); then both on (1, 8) over 4 rows, too few for
the mesh: their products split by columns over "model" (xLSTM's
``_split_cols``, Whisper's ``AttnCfg.split_cols``), a step and a float32
prefill over 12 tokens with one decode step.  The test process runs the
reference's jitted step on one device from the same params and batch.
The metrics are held within 1e-5 relative and each leaf of the first and
second moments within 1e-4 of its largest entry
(``_lm_reference.assert_step_matches``' gates); the logits within 1e-4
(``tests/test_torch_sharded_families.py``'s float32 gate, against its
reference).
"""
import importlib.util
import os
import threading

import jax
import numpy as np
import pytest

from _lm_reference import (JCTX, TRAIN_OPT, _assert_leaves_close,
                           _moments, as_jax, pair)
from repro.models import make_arch as jmake_arch
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
fams = _load("test_torch_sharded_families")

F32_RTOL = 1e-4
METRIC_RTOL = 1e-5


def _reference_step(p, rows=lw.TRAIN_ROWS):
    jarch = jmake_arch(p.jcfg)
    opt = JAdamWConfig(**TRAIN_OPT)
    batch = lw.inputs(p.jcfg, rows, lw.TRAIN_SEQ, lw.TRAIN_SEED)
    step = jax.jit(jmake_train_step(jarch, opt, JCTX))
    _, state, met = step(p.jparams, jinit_opt_state(p.jparams, opt),
                         as_jax(batch, "f32"))
    return ({k: float(v) for k, v in met.items()},
            {k: _moments(state[k], True) for k in ("m", "v")})


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("recurrent_world"))
    pairs = {a: pair(a, "f32", fan_in=True) for a in lw.RECURRENT}
    for a, p in pairs.items():
        lw.write_params(os.path.join(out, f"params_{a}.npz"),
                        jax.tree.map(np.asarray, p.jparams))
    box = {}

    def run():
        try:
            box["records"] = dw.run_world("recurrent", 8, out, timeout=600,
                                          script=lw.SCRIPT)
        except BaseException as e:      # re-raised in the test
            box["error"] = e
    th = threading.Thread(target=run)
    th.start()
    ref = {f"step/{a}": _reference_step(p) for a, p in pairs.items()}
    name, _, rows = lw.ROWS_SPLIT
    ref[f"rows/{name}"] = _reference_step(pairs[name], rows)
    for a in lw.COLS_SPLIT:
        ref[f"cols/{a}"] = ref[f"step/{a}"]
        ref[f"colserve/{a}"] = fams._serve_reference(
            a, jax.tree.map(np.asarray, pairs[a].jparams))
    th.join()
    if "error" in box:
        raise box["error"]

    def result(key):
        with np.load(os.path.join(out, key.replace("/", "__") + ".npz")) as f:
            return {k: f[k] for k in f.files}
    return {"ref": ref, "result": result}


@pytest.mark.parametrize("key", [f"step/{a}" for a in lw.RECURRENT]
                         + [f"rows/{lw.ROWS_SPLIT[0]}"]
                         + [f"cols/{a}" for a in lw.COLS_SPLIT])
def test_sharded_step_matches_single_device(steps, key):
    (jmet, jmoments), got = steps["ref"][key], steps["result"](key)
    for k in ("loss_total", "loss", "grad_norm", "lr"):
        assert float(got[f"metric_{k}"]) == pytest.approx(
            jmet[k], rel=METRIC_RTOL), k
    assert jmet["grad_norm"] > 1.0             # the clip is active
    for key in ("m", "v"):
        mine = [v for k, v in got.items() if k.startswith(key + "[")]
        _assert_leaves_close(jmoments[key], mine, F32_RTOL)


@pytest.mark.parametrize("arch", lw.COLS_SPLIT)
def test_column_split_serving_matches_single_device(steps, arch):
    want = steps["ref"][f"colserve/{arch}"]
    got = steps["result"](f"colserve/{arch}")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = float(np.abs(got[k] - want[k]).max())
        assert err < fams.F32_LOGITS, (k, err)
