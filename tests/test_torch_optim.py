"""The port's optimizer (``repro_torch.optim``) against the reference's.

The same inputs, made from a seed with numpy, go through ``repro.optim``
(jitted) and ``repro_torch.optim`` on the CPU:

* ``schedule`` over warmup, the cosine and past its end: within 1e-7 of
  the peak rate (XLA's and torch's ``cos`` may part by an ulp, which
  ``1 + cos`` amplifies where the cosine nears -1: 3 ulps of the rate,
  3.7e-8 of the peak, measured);
* ``apply_updates`` over several steps on the same grads with the clip
  active: the f32 master weights within 1e-6 of each leaf's max
  (measured 7.4e-8), bf16 params within one bf16 ulp of the reference's
  (or that 1e-6, near 0),
  the grad norm and the learning rate within 1e-6 relative; with 8-bit
  state the m codes equal and the v codes within one step (a log-space
  code may move by one where ``log``/``exp`` part by an ulp); an entry
  whose v code moved (at most 1% of a leaf) updates by a few % more or
  less from then on, and its master is held within STEPS * lr;
* the block quantizers' round trips, and their error bounds;
* ``compress_leaf`` / ``compress_tree`` bitwise in f32, and the error
  feedback's sum equal to the raw grads' sum;
* ``opt_state_specs`` against the reference's specs, and the
  reference's own optimizer state carried into the port by
  ``params_from_reference``, stepped on in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import PSpec as JPSpec, is_pspec as jis_pspec
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro.optim import compress as jcompress
from repro.optim import init_opt_state as jinit
from repro.optim import opt_state_specs as jstate_specs
from repro.optim import schedule as jschedule
from repro_torch import params_from_reference
from repro_torch.models.common import PSpec, tree_leaves
from repro_torch.optim import (AdamWConfig, apply_updates, global_norm,
                               init_opt_state, opt_state_specs, schedule)
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress

CFG = dict(lr=1e-2, warmup_steps=3, total_steps=12, grad_clip=0.5,
           weight_decay=0.1)
MASTER_RTOL = 1e-6
STEPS = 6


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _tleaves(tree):
    return [t.numpy() for t in tree_leaves(tree, torch.is_tensor)]


def _params(rng, dtype):
    """A tree with a scalar, a ragged last axis and a padded block."""
    p = {"a": rng.standard_normal((4, 300)),
         "b": {"c": rng.standard_normal((7,)),
               "d": rng.standard_normal((3, 5, 260))},
         "s": np.asarray(rng.standard_normal())}
    return jax.tree.map(lambda x: np.asarray(x, np.float32), p), dtype


def _as_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


@pytest.mark.parametrize("kw", [dict(warmup_steps=10, total_steps=110),
                                dict(warmup_steps=0, total_steps=50,
                                     min_lr_frac=0.0),
                                dict(warmup_steps=1, total_steps=1)])
def test_schedule_matches_reference(kw):
    jc, tc = JAdamWConfig(lr=0.3, **kw), AdamWConfig(lr=0.3, **kw)
    for step in range(0, kw["total_steps"] + 20):
        want = np.float32(jschedule(jc, jnp.int32(step)))
        got = schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-7 * jc.lr, step


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_updates_matches_reference(quant, dtype, rng):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    p, _ = _params(rng, dtype)
    jp = _as_jax(p, jdt)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    jc, tc = (JAdamWConfig(**CFG, quantize_state=quant),
              AdamWConfig(**CFG, quantize_state=quant))
    js, ts = jinit(jp, jc), init_opt_state(tp, tc)
    step = jax.jit(lambda p_, g_, s_: japply(p_, g_, s_, jc))
    # entries whose v code has differed by one step: their later updates
    # part (by a few % of one step's size)
    parted = [np.zeros(np.shape(x), bool) for x in jax.tree.leaves(p)]
    for _ in range(STEPS):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3)
                         .astype(np.float32), p)
        jg = _as_jax(g, jdt)
        jp, js, jm = step(jp, jg, js)
        tp, ts, tm = apply_updates(
            tp, params_from_reference(jax.tree.map(np.asarray, jg),
                                      device="cpu"), ts, tc)
        assert float(jm["grad_norm"]) > 2 * CFG["grad_clip"]   # clipping
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        assert int(ts["step"]) == int(js["step"])
        if quant:
            for i, (want, got) in enumerate(zip(
                    jax.tree.leaves(js["v"], is_leaf=lambda x: "q" in x),
                    tree_leaves(ts["v"], tadamw._is_moment))):
                d = np.asarray(want["q"]) != got["q"].numpy()
                parted[i] |= tadamw._unblocked(
                    torch.from_numpy(d), parted[i].shape).numpy()
        for want, got, moved in zip(_leaves(js["master"]),
                                    _tleaves(ts["master"]), parted):
            assert got.dtype == np.float32
            assert moved.mean() <= 0.01
            tol = np.where(moved, STEPS * CFG["lr"],
                           MASTER_RTOL * np.abs(want).max())
            assert np.all(np.abs(got - want) <= tol)
        for want, got in zip(jax.tree.leaves(jp),
                             tree_leaves(tp, torch.is_tensor)):
            assert got.dtype == tdt
            want = np.asarray(want, np.float32)
            # the master weights themselves, or in bf16 rounded: one bf16
            # ulp apart, or more near 0, where masters that agree to
            # MASTER_RTOL of the leaf's max span several ulps
            tol = MASTER_RTOL * np.abs(want).max()
            if dtype == "bf16":
                tol = np.maximum(tol, np.spacing(np.abs(want)) * 2 ** 16)
            assert np.all(np.abs(got.float().numpy() - want) <= tol)
        jmom, tmom = (_leaves(js["m"]) + _leaves(js["v"]),
                      _tleaves(ts["m"]) + _tleaves(ts["v"]))
        assert [a.dtype for a in jmom] == [a.dtype for a in tmom]
        for i, (want, got) in enumerate(zip(jmom, tmom)):
            assert want.shape == got.shape
            if want.dtype == np.int8:     # m codes, then v codes
                d = np.abs(got.astype(int) - want.astype(int))
                assert d.max() <= (0 if i < len(jmom) // 2 else 1)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())


def test_quantizer_round_trips_match_reference(rng):
    for shape in [(1000,), (7, 300), (3, 256), ()]:
        x = np.asarray(rng.standard_normal(shape)
                       * 10.0 ** rng.uniform(-6, 2, shape), np.float32)
        js = jadamw._quantize_signed(jnp.asarray(x))
        ts = tadamw._quantize_signed(torch.from_numpy(x.copy()))
        np.testing.assert_array_equal(ts["q"].numpy(), np.asarray(js["q"]))
        np.testing.assert_array_equal(ts["scale"].numpy(),
                                      np.asarray(js["scale"]))
        deq = tadamw._dequantize_signed(ts, shape).numpy()
        np.testing.assert_array_equal(
            deq, np.asarray(jadamw._dequantize_signed(js, shape)))
        assert deq.shape == shape
        assert np.abs(deq - x).max() <= np.abs(x).max() / 127.0 + 1e-7
        v = np.asarray(np.abs(x))
        jl = jadamw._quantize_log(jnp.asarray(v))
        tl = tadamw._quantize_log(torch.from_numpy(v.copy()))
        assert np.abs(tl["q"].numpy().astype(int)
                      - np.asarray(jl["q"]).astype(int)).max() <= 1
        for k in ("mn", "span"):
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-6)
        back = tadamw._dequantize_log(tl, shape).numpy()
        assert back.shape == shape
        rel = np.abs(back - v) / (v + 1e-30)
        assert rel[v > 1e-19].max() < 0.25


def test_quantized_state_of_zeros_matches_reference():
    """Zero moments quantize to the reference's codes and scales; the log
    code of zero dequantizes to exactly zero."""
    z = np.zeros((2, 300), np.float32)
    js, ts = (jadamw._quantize_log(jnp.asarray(z)),
              tadamw._quantize_log(torch.from_numpy(z)))
    for k in ("q", "mn", "span"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    assert not tadamw._dequantize_log(ts, z.shape).any()


def test_global_norm_matches_reference(rng):
    tree = {"b": rng.standard_normal((300,)).astype(np.float32),
            "a": {"y": rng.standard_normal((5, 7)).astype(np.float32),
                  "x": rng.standard_normal((2,)).astype(np.float32)}}
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = global_norm(params_from_reference(tree, device="cpu"))
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_compress_leaf_bitwise_and_error_feedback(rng):
    for shape in [(3, 100), (256,), (5, 7, 9)]:
        jerr = jnp.zeros(shape, jnp.float32)
        terr = torch.zeros(shape)
        raw = np.zeros(shape, np.float64)
        total = torch.zeros(shape, dtype=torch.float64)
        for _ in range(12):
            g = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
            jq, jscale, jerr = jcompress.compress_leaf(jnp.asarray(g), jerr)
            tq, tscale, terr = tcompress.compress_leaf(torch.from_numpy(g),
                                                       terr)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
            np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
            deq = tcompress.decompress_leaf(tq, tscale, shape)
            np.testing.assert_array_equal(
                deq.numpy(),
                np.asarray(jcompress.decompress_leaf(jq, jscale, shape)))
            raw += g
            total += deq.double()
        # unbiased over time: what was sent plus what is owed
        np.testing.assert_allclose((total + terr.double()).numpy(), raw,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_compress_tree_bitwise(dtype, rng):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    g = {"w": rng.standard_normal((4, 300)).astype(np.float32),
         "n": {"b": rng.standard_normal((9,)).astype(np.float32)}}
    jg = _as_jax(g, jdt)
    tg = params_from_reference(jax.tree.map(np.asarray, jg), device="cpu")
    jerr = jcompress.init_error(jg)
    terr = tcompress.init_error(tg)
    for _ in range(3):
        jout, jerr = jcompress.compress_tree(jg, jerr)
        tout, terr_new = tcompress.compress_tree(tg, terr)
        assert terr_new is terr                   # updated in place
        for want, got in zip(jax.tree.leaves(jout),
                             tree_leaves(tout, torch.is_tensor)):
            assert got.dtype == tg["w"].dtype
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        for want, got in zip(_leaves(jerr), _tleaves(terr)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant", [False, True])
def test_opt_state_specs_match_reference(quant):
    jspecs = {"w": JPSpec((3, 300), ("fsdp", "tp")),
              "b": JPSpec((7,), (None,)), "s": JPSpec((), ())}
    tspecs = {"w": PSpec((3, 300), ("fsdp", "tp")),
              "b": PSpec((7,), (None,)), "s": PSpec((), ())}
    want = jax.tree.leaves(jstate_specs(jspecs, JAdamWConfig(
        quantize_state=quant)), is_leaf=jis_pspec)
    got = list(tree_leaves(opt_state_specs(tspecs, AdamWConfig(
        quantize_state=quant))))
    assert [(w.shape, w.logical, jnp.dtype(w.dtype).name, w.init)
            for w in want] == [(g.shape, g.logical,
                                str(g.dtype).split(".")[-1], g.init)
                               for g in got]


def test_reference_state_carries_into_the_port(rng):
    """``params_from_reference`` carries the reference's quantized
    optimizer state (int8 codes, an int32 step, nested dicts); both
    packages then step on from it alike."""
    p, _ = _params(rng, "f32")
    jc, tc = (JAdamWConfig(**CFG, quantize_state=True),
              AdamWConfig(**CFG, quantize_state=True))
    jp = _as_jax(p, jnp.float32)
    js = jinit(jp, jc)
    step = jax.jit(lambda p_, g_, s_: japply(p_, g_, s_, jc))
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape)
                          .astype(np.float32), p) for _ in range(4)]
    for g in grads[:2]:
        jp, js, _ = step(jp, _as_jax(g, jnp.float32), js)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    ts = params_from_reference(jax.tree.map(np.asarray, js), device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 2
    assert ts["m"]["a"]["q"].dtype == torch.int8
    for g in grads[2:]:
        jp, js, _ = step(jp, _as_jax(g, jnp.float32), js)
        tp, ts, _ = apply_updates(
            tp, params_from_reference(g, device="cpu"), ts, tc)
    for want, got in zip(_leaves(js["master"]), _tleaves(ts["master"])):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=MASTER_RTOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_slices_are_bitwise(dtype, monkeypatch):
    """On the host a large leaf is updated in row slices
    (``HOST_SLICE``); the values equal the update in one piece."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"w": (7, 300), "v": (2000,), "s": ()}
    params = {k: torch.randn(s, generator=gen).to(dtype)
              for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen).to(dtype)
              for k, s in shapes.items()} for _ in range(3)]
    out = []
    for slice_ in (1 << 30, 64):
        monkeypatch.setattr(tadamw, "HOST_SLICE", slice_)
        c = AdamWConfig(**CFG)
        p = {k: v.clone() for k, v in params.items()}
        st = init_opt_state(p, c)
        for g in grads:
            apply_updates(p, g, st, c)
        out.append((p, st))
    for a, b in zip(tree_leaves(out[0], torch.is_tensor),
                    tree_leaves(out[1], torch.is_tensor)):
        assert torch.equal(a, b)
