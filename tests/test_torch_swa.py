"""Sliding-window attention (K5): ``repro_torch`` against ``repro``.

The same numpy inputs (seeded) go through the JAX package — its dense
oracle ``swa_ref`` and ``ops.swa`` (the Pallas kernel in interpret mode)
— and through the port on the CPU, where ``ops.swa`` runs K5's plain
version.  Also ``ops.stencil_apply`` against the reference's, and a
``cuda``-marked test of K5 against its plain version that skips itself
without a card.
"""
import importlib.util
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PAPER_STENCILS
from repro.kernels import ops as jops
from repro.kernels.swa import swa_ref as jswa_ref
from repro_torch import spec_from_reference, tensor_from_numpy
from repro_torch.kernels import LAUNCHES, ops, swa_ref
from repro_torch.kernels import swa as tswa

# a fixed, seeded subset of the reference property test's matrix:
# (b, hkv, g, s, d, w, softcap)
_MATRIX = list(itertools.product((1, 2), (1, 2), (1, 2, 4), (64, 96),
                                 (16, 32), (8, 32, 64), (None, 50.0)))
CASES = [_MATRIX[i] for i in sorted(
    np.random.default_rng(2021).choice(len(_MATRIX), 14, replace=False))]


def _qkv(b, hkv, g, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hkv * g, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _port(*arrays, dtype=torch.float32):
    return [tensor_from_numpy(a, dtype) for a in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_swa_ref_matches_reference_oracle(case):
    b, hkv, g, s, d, w, softcap = case
    q, k, v = _qkv(b, hkv, g, s, d, seed=sum(case[:6]))
    got = swa_ref(*_port(q, k, v), w, softcap=softcap)
    want = np.asarray(jswa_ref(*_jax(q, k, v), w, softcap=softcap))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ops_swa_matches_reference_kernel(case):
    """The port's ops.swa on CPU (K5's plain version) against the Pallas
    kernel in interpret mode, both with tq=32."""
    b, hkv, g, s, d, w, softcap = case
    q, k, v = _qkv(b, hkv, g, s, d, seed=100 + sum(case[:6]))
    got = ops.swa(*_port(q, k, v), window=w, tq=32, softcap=softcap)
    want = np.asarray(jops.swa(*_jax(q, k, v), window=w, tq=32,
                               softcap=softcap))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_window_covering_sequence_is_causal():
    b, hkv, g, s, d = 1, 2, 2, 64, 16
    q, k, v = _port(*_qkv(b, hkv, g, s, d, seed=7))
    got = ops.swa(q, k, v, window=s, tq=32)
    causal = torch.nn.functional.scaled_dot_product_attention(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        is_causal=True)
    torch.testing.assert_close(got, causal, rtol=0, atol=2e-5)
    torch.testing.assert_close(ops.swa(q, k, v, window=10 * s, tq=32), got,
                               rtol=0, atol=0)


def test_window_one_returns_v():
    b, hkv, g, s, d = 2, 2, 2, 64, 16
    q, k, v = _port(*_qkv(b, hkv, g, s, d, seed=8))
    got = ops.swa(q, k, v, window=1, tq=32, softcap=50.0)
    torch.testing.assert_close(got, v.repeat_interleave(g, 1), rtol=0,
                               atol=0)


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("s, d, w, tq", [(100, 16, 24, 32), (96, 64, 40, 64)])
def test_sequence_not_a_multiple_of_tq(s, d, w, tq, softcap):
    b, hkv, g = 1, 2, 2
    q, k, v = _qkv(b, hkv, g, s, d, seed=9)
    got = ops.swa(*_port(q, k, v), window=w, tq=tq, softcap=softcap)
    want = np.asarray(jops.swa(*_jax(q, k, v), window=w, tq=tq,
                               softcap=softcap))
    assert tuple(got.shape) == (b, hkv * g, s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_bf16_matches_f32_oracle():
    """bf16 inputs (rounded alike by both packages) against the f32
    oracle within bf16 tolerance, as the reference's test holds Pallas."""
    b, hq, hkv, s, d, w = 1, 4, 2, 128, 32, 32
    q, k, v = _qkv(b, hkv, hq // hkv, s, d, seed=10)
    tq_, tk, tv = _port(q, k, v, dtype=torch.bfloat16)
    jq, jk, jv = _jax(q, k, v, dtype=jnp.bfloat16)
    for t, j in ((tq_, jq), (tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))
    got = ops.swa(tq_, tk, tv, window=w, tq=32)
    assert got.dtype == torch.bfloat16
    want = swa_ref(tq_.float(), tk.float(), tv.float(), w)
    assert (got.float() - want).abs().max().item() < 0.08
    ref = np.asarray(jops.swa(jq, jk, jv, window=w, tq=32).astype(
        jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() < 0.08


def test_wrapper_rejects_bad_arguments():
    q, k, v = _port(*_qkv(1, 2, 2, 32, 16, seed=12))
    with pytest.raises(ValueError):
        ops.swa(q, k[:, :1].expand(1, 1, 32, 16), v, window=4)
    with pytest.raises(ValueError):
        ops.swa(q[:, :3], k, v, window=4)
    with pytest.raises(ValueError):
        ops.swa(q, k, v, window=0)
    with pytest.raises(ValueError):
        ops.swa(q, k, v, window=4, tq=0)
    with pytest.raises(ValueError):
        ops.swa(q.to("meta"), k.to("meta"), v.to("meta"), window=4)


@pytest.mark.parametrize("name", ["jacobi2d", "blur2d", "heat3d"])
def test_ops_stencil_apply_matches_reference(name):
    ref = PAPER_STENCILS[name]
    shape = {2: (40, 70), 3: (9, 20, 37)}[ref.ndim]
    g = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    got = ops.stencil_apply(spec_from_reference(ref),
                            tensor_from_numpy(g, torch.float32), sweeps=2)
    want = np.asarray(jops.stencil_apply(ref, jnp.asarray(g), sweeps=2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _chip_smoke():
    """``chip_smoke.py`` (repo root) as a module: its tolerances and its
    ``within_bf16_ulp`` check."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (b, hkv, g, s, d, w, softcap, tq): CASES at tq=32, then every other
# head dim K5 is built for and tq 64 and 128
CARD_CASES = [c + (32,) for c in CASES] + [
    (1, 2, 2, 100, 64, 32, 50.0, 64), (2, 1, 4, 96, 256, 64, None, 64),
    (1, 2, 1, 128, 128, 8, 50.0, 128), (1, 1, 2, 64, 256, 1, 50.0, 128)]


@pytest.mark.cuda
def test_k5_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    smoke = _chip_smoke()
    assert {c[4] for c in CARD_CASES} == set(tswa.HEAD_DIMS)
    for case in CARD_CASES:
        b, hkv, g, s, d, w, softcap, tq = case
        arrays = _qkv(b, hkv, g, s, d, seed=200 + sum(case[:6]))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = [tensor_from_numpy(a, dtype, "cuda") for a in arrays]
            before = LAUNCHES["K5"]
            got = ops.swa(q, k, v, window=w, tq=tq, softcap=softcap)
            torch.cuda.synchronize()
            assert LAUNCHES["K5"] == before + 1
            want = tswa.sliding_window_attention_plain(q, k, v, w, tq,
                                                       softcap)
            if dtype == torch.float32:
                err = (got.double() - want.double()).abs().max().item()
                assert err <= smoke.SWA_F32_ATOL, case
                continue
            # one bf16 ulp of the plain version (at least the floor, for
            # outputs that cancel), and bitwise the f32 kernel's result
            # on the widened inputs, rounded once
            assert smoke.within_bf16_ulp(got, want, smoke.SWA_BF16_FLOOR), case
            f32 = ops.swa(q.float(), k.float(), v.float(), window=w, tq=tq,
                          softcap=softcap)
            assert torch.equal(got, f32.to(torch.bfloat16)), case
