"""Sliding-window attention (K5): ``repro_torch`` against ``repro``.

The same numpy inputs (seeded) go through the JAX package — its dense
oracle ``swa_ref`` and ``ops.swa`` (the Pallas kernel in interpret mode)
— and through the port on the CPU, where ``ops.swa`` runs K5's plain
version.  Also ``ops.stencil_apply`` against the reference's; the CPU
mirror of the tensor-core kernels' arithmetic (``_swa_tc_mirror``: bf16
and f16 on wgmma, f32 in three TF32 passes) against the plain version and
the reference, with the splits they rely on (P into bf16 or scaled f16
terms, f32 operands into TF32 halves); and a ``cuda``-marked test of K5
against its plain version that skips itself without a card.
"""
import importlib.util
import itertools
import math
import re
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

from _hypothesis_compat import given, settings, st
import _swa_tc_mirror as mirror
from _swa_tc_mirror import split_terms, split_tf32, swa_tc_mirror

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


# shapes the card used to refuse, the reference takes any: head dims 112
# (zamba2_7b) and 192 (nemotron4_340b, 12 query heads per KV head), 32
# query heads per KV head, and float16: (b, hkv, g, s, d, w, softcap, dtype)
WIDE_CASES = [
    (1, 1, 2, 64, 112, 32, None, np.float32),
    (1, 1, 12, 40, 192, 16, 50.0, np.float32),
    (1, 1, 32, 40, 32, 8, None, np.float32),
    (1, 2, 2, 64, 64, 32, 50.0, np.float16),
    (1, 1, 4, 48, 112, 16, None, np.float16),
]


@pytest.mark.parametrize("case", WIDE_CASES, ids=str)
def test_ops_swa_wide_shapes_match_reference_kernel(case):
    """The port's plain version on the shapes K5 now takes on the card
    against the Pallas kernel in interpret mode (tq=32): f32 within 2e-5;
    float16 (both widen to f32 and round once) within one f16 ulp, or
    chip_smoke's 4e-6 floor where outputs cancel (the two f32 sums differ
    in order), the rule the card holds K5 to."""
    b, hkv, g, s, d, w, softcap, dt = case
    q, k, v = [a.astype(dt) for a in _qkv(b, hkv, g, s, d, seed=s + d + g)]
    tdt = torch.float16 if dt == np.float16 else torch.float32
    jdt = jnp.float16 if dt == np.float16 else jnp.float32
    got = ops.swa(*_port(q, k, v, dtype=tdt), window=w, tq=32,
                  softcap=softcap)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    want = np.asarray(jops.swa(*_jax(q, k, v, dtype=jdt), window=w, tq=32,
                               softcap=softcap))
    if dt == np.float16:
        smoke = _chip_smoke()
        assert smoke.within_bf16_ulp(got, torch.from_numpy(want),
                                     smoke.SWA_BF16_FLOOR, bits=10)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_head_dim_instances_and_group_split():
    """Head dims that are multiples of 16 up to 256 run on the next built
    instance; the tensor-core kernel splits more than 16 query heads per
    KV head into equal shares of at most 16."""
    assert [tswa.instance_dim(d) for d in (16, 48, 64, 112, 128, 192, 256)] \
        == [16, 64, 64, 128, 128, 256, 256]
    assert [tswa.instance_dim(d) for d in (8, 100, 272)] == [0, 0, 0]
    assert [tswa.tc_heads_per_cta(g) for g in (1, 12, 16, 17, 24, 32, 48)] \
        == [1, 12, 16, 9, 12, 16, 16]
    assert [tswa.tc_chunk_keys(d) for d in (112, 192)] == [128, 64]


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
    (1, 2, 1, 128, 128, 8, 50.0, 128), (1, 1, 2, 64, 256, 1, 50.0, 128),
    (1, 2, 2, 128, 128, 64, 1.0, 64),   # softcap 1: tanhf's range too
    (1, 1, 2, 100, 112, 32, 50.0, 64), (1, 1, 12, 96, 192, 40, None, 32),
    (1, 2, 32, 64, 64, 16, 50.0, 32)]   # head dims 112, 192; G = 32


@pytest.mark.cuda
def test_k5_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    smoke = _chip_smoke()
    assert {c[4] for c in CARD_CASES} >= set(tswa.HEAD_DIMS)
    for case in CARD_CASES:
        b, hkv, g, s, d, w, softcap, tq = case
        arrays = _qkv(b, hkv, g, s, d, seed=200 + sum(case[:6]))
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
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
            if dtype == torch.float16:
                assert smoke.within_bf16_ulp(got, want, smoke.SWA_BF16_FLOOR,
                                             bits=10), case
                continue
            # one bf16 ulp of the plain version (at least the floor, for
            # outputs that cancel), and of the f32 kernel (three TF32
            # passes) on the widened inputs (each sums in its own order)
            assert smoke.within_bf16_ulp(got, want, smoke.SWA_BF16_FLOOR), case
            f32 = ops.swa(q.float(), k.float(), v.float(), window=w, tq=tq,
                          softcap=softcap)
            assert smoke.within_bf16_ulp(got, f32, smoke.SWA_BF16_FLOOR), case


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.integers(-100, 0), st.integers(0, 2 ** 23 - 1))
def test_three_bf16_terms_reconstruct_f32_p(exponent, mantissa):
    """Any f32 p in [2^-100, 1]: three bf16 terms (each the rounding of
    what the earlier left) sum back to p exactly, two to within 2^-16
    relative — the split the tensor-core kernel feeds to P.V."""
    p = min(math.ldexp(1.0 + mantissa / 2 ** 23, exponent), 1.0)
    x = torch.tensor([p], dtype=torch.float32)
    three = split_terms(x, 3, torch.bfloat16)
    assert all(torch.equal(t.to(torch.bfloat16).float(), t) for t in three)
    assert torch.equal(three[0] + three[1] + three[2], x)
    assert ((three[0] + three[1]) - x).abs().item() <= 2.0 ** -16 * p


# (b, hkv, g, s, d, w, softcap) drawn from chip_smoke.SWA_MATRIX's small
# sizes, every head dim and window among them
_TC_MATRIX = [c for c in itertools.product(
    (1, 2), (1, 2), (1, 2, 4), (64, 96, 128, 100), (16, 32, 64, 128, 256),
    (1, 8, 32, 64, None), (None, 50.0))]
TC_CASES = [_TC_MATRIX[i] for i in sorted(
    np.random.default_rng(2024).choice(len(_TC_MATRIX), 12, replace=False))]
TC_CASES += [(1, 2, 2, 100, 256, None, 50.0), (2, 1, 4, 128, 16, 1, None),
             # head dims 112 and 192 (zero-filled instance columns), and
             # groups of 32 and 24 query heads split over two CTAs
             (1, 1, 2, 100, 112, 32, 50.0), (1, 1, 12, 64, 192, None, None),
             (1, 1, 32, 64, 32, 16, None), (1, 1, 24, 40, 16, 8, 50.0)]


def test_tc_block_geometry():
    """The tensor-core kernel's positions per CTA: 128 rows head-major,
    each head's box a whole number of 8-row swizzle atoms; G > 16 is
    refused (0), and chunks are 64 keys only at D = 256."""
    assert [tswa.tc_positions(g) for g in (1, 2, 3, 4, 5, 16, 17)] == [
        128, 64, 40, 32, 24, 8, 0]
    assert [tswa.tc_chunk_keys(d) for d in tswa.HEAD_DIMS] == [
        128, 128, 128, 128, 64]


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_tc_mirror_matches_plain_and_reference(case, terms):
    """The tensor-core kernel's arithmetic, mirrored on the CPU, against
    the port's plain version (one bf16 ulp, at least chip_smoke's floor:
    the check the card applies) and the JAX oracle (0.08).  The kernel
    splits P into ``tswa.TC_TERMS`` terms; that count must pass the ulp
    check, the other count's largest gap is printed (``-s``)."""
    smoke = _chip_smoke()
    b, hkv, g, s, d, w, softcap = case
    w = s if w is None else w
    q, k, v = _qkv(b, hkv, g, s, d, seed=300 + sum(case[:5]) + w)
    tq_, tk, tv = _port(q, k, v, dtype=torch.bfloat16)
    got32 = swa_tc_mirror(tq_, tk, tv, w, softcap, terms=terms,
                          out_dtype=torch.float32)
    got = got32.to(torch.bfloat16)
    plain = tswa.sliding_window_attention_plain(tq_, tk, tv, w, 32, softcap)
    plain32 = tswa.sliding_window_attention_plain(
        tq_.float(), tk.float(), tv.float(), w, 32, softcap)
    print(f"terms={terms} {case}: largest f32 |mirror - plain| "
          f"{(got32 - plain32).abs().max().item():.3g}")
    ref = np.asarray(jswa_ref(*_jax(q, k, v, dtype=jnp.bfloat16), w,
                              softcap=softcap).astype(jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() < 0.08
    if terms == tswa.TC_TERMS:
        assert smoke.within_bf16_ulp(got, plain, smoke.SWA_BF16_FLOOR), case


def test_kernel_tanh_polynomial_within_one_ulp():
    """The tensor-core kernels' tanh for |y| <= 0.55 (``tanh_small``,
    mirrored in f32 with one rounding per fmaf) lies within one f32 ulp of
    tanh on a dense sweep of f32 values, and the mirror's coefficients are
    the ones in the CUDA source (the header both kernels include)."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "kernels" / "csrc" / "swa_common.cuh").read_text()
    body = src[src.index("float tanh_small(float y)"):]
    body = body[:body.index("\n}")]
    lits = [float(x) for x in re.findall(r"(-?\d\.\d+e[-+]\d+)f", body)]
    assert sorted(lits) == sorted(mirror.TANH_POLY)
    lo = int(np.float32(2.0 ** -14).view(np.int32))
    hi = int(np.float32(mirror.TANH_SMALL_MAX).view(np.int32))
    bits = np.arange(lo, hi + 1, 61, dtype=np.int32)
    y = torch.from_numpy(np.concatenate([bits.view(np.float32),
                                         -bits.view(np.float32)]))
    got = mirror.tanh_small(y).double()
    want = torch.tanh(y.double())
    ulp = torch.from_numpy(np.spacing(want.float().abs().numpy())).double()
    worst = ((got - want).abs() / ulp).max().item()
    print(f"tanh_small: largest error {worst:.3f} f32 ulp over "
          f"{y.numel()} values")
    assert worst <= 1.0


# f16 (wgmma, P * 2**15 in f16 terms) and f32 (three TF32 passes): the
# mirror against the port's plain version at the card's limits and
# against the JAX reference.  f16 runs with 1 and 2 terms of P; the
# kernel's count (tswa.TC_TERMS_F16) must pass, the other's largest gap
# is printed (``-s``).
TC_F_CASES = [("float32", None, c)
              for c in dict.fromkeys(TC_CASES[::2] + TC_CASES[-4:])]
TC_F_CASES += [("float16", t, c) for t in (1, 2)
               for c in dict.fromkeys(TC_CASES[1::2] + TC_CASES[-4:])]


@pytest.mark.parametrize("dtype, terms, case", TC_F_CASES, ids=str)
def test_tc_mirror_f16_f32_match_plain_and_reference(dtype, terms, case):
    """The f32 mirror within 2e-5 of the port's plain version, of
    ``repro.kernels.ops.swa`` (interpret mode) and of ``swa_ref``; the f16
    mirror within one f16 ulp, at least chip_smoke's 4e-6 floor, of the
    plain version and of both references on the same f16 inputs."""
    smoke = _chip_smoke()
    b, hkv, g, s, d, w, softcap = case
    w = s if w is None else w
    q, k, v = _qkv(b, hkv, g, s, d, seed=400 + sum(case[:5]) + w)
    f16 = dtype == "float16"
    tdt, jdt = ((torch.float16, jnp.float16) if f16
                else (torch.float32, jnp.float32))
    tq_, tk, tv = _port(q, k, v, dtype=tdt)
    got32 = swa_tc_mirror(tq_, tk, tv, w, softcap, terms=terms,
                          out_dtype=torch.float32)
    got = got32.to(tdt)
    plain = tswa.sliding_window_attention_plain(tq_, tk, tv, w, 32, softcap)
    plain32 = tswa.sliding_window_attention_plain(
        tq_.float(), tk.float(), tv.float(), w, 32, softcap)
    gap = (got32 - plain32).abs().max().item()
    print(f"{dtype} terms={terms} {case}: largest f32 |mirror - plain| "
          f"{gap:.3g}")
    if f16 and terms != tswa.TC_TERMS_F16:
        return
    jq, jk, jv = _jax(q, k, v, dtype=jdt)
    refs = [plain,
            torch.from_numpy(np.asarray(jops.swa(jq, jk, jv, window=w, tq=32,
                                                 softcap=softcap))),
            torch.from_numpy(np.asarray(jswa_ref(jq, jk, jv, w,
                                                 softcap=softcap)))]
    for want in refs:
        assert want.dtype == tdt and want.shape == got.shape
        if f16:
            assert smoke.within_bf16_ulp(got, want, smoke.SWA_BF16_FLOOR,
                                         bits=10), case
        else:
            err = (got.double() - want.double()).abs().max().item()
            assert err <= smoke.SWA_F32_ATOL, (case, err)


def test_tc_f32_chunk_geometry():
    """The f32 kernel's chunks: 64 keys, 32 at D = 256 (its shared memory
    holds a 128-row Q and the K/V ring in f32); the 16-bit kernel's
    unchanged."""
    assert [tswa.tc_chunk_keys(d, torch.float32) for d in tswa.HEAD_DIMS] \
        == [64, 64, 64, 64, 32]
    assert [tswa.tc_chunk_keys(d, torch.float16) for d in tswa.HEAD_DIMS] \
        == [tswa.tc_chunk_keys(d) for d in tswa.HEAD_DIMS]
    assert tswa._ENTRY[torch.float32][0] == "swa_tf32.cu"
    assert {tswa._ENTRY[dt][0] for dt in (torch.float16, torch.bfloat16)} \
        == {"swa_wgmma.cu"}


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.integers(-100, 127), st.integers(0, 2 ** 23 - 1), st.booleans())
def test_tf32_halves_reconstruct_f32(exponent, mantissa, negative):
    """Any f32 x with 2^-100 <= |x|: the two TF32 halves of the f32
    kernel, as the tensor cores read them (low 13 bits dropped), are tf32
    values whose sum is x within 2^-21 |x|; x - trunc(x) is exact in f32.
    (Below about 2^-103 the small half turns subnormal and keeps fewer
    bits; such operands add below 2^-100 to the kernel's sums.)"""
    x = math.ldexp(1.0 + mantissa / 2 ** 23, exponent)
    x = -x if negative else x
    t = torch.tensor([x], dtype=torch.float32)
    if not torch.isfinite(t).all():
        return
    big, small = split_tf32(t)
    for h in (big, small):
        assert int(h.view(torch.int32).item()) & 0x1FFF == 0
    xd = t.double().item()
    assert (t - big).double().item() == xd - big.double().item()
    err = abs(xd - big.double().item() - small.double().item())
    assert err <= 2.0 ** -21 * abs(xd)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.integers(-18, 0), st.integers(0, 2 ** 23 - 1))
def test_scaled_f16_terms_reconstruct_p(exponent, mantissa):
    """Any f32 p in [2^-18, 1]: p * 2^15 (exact, at most 32768 < 65504)
    as two f16 terms, each the rounding of what the earlier left, sums
    back to within 2^-22 relative, one term to 2^-11 — the split the f16
    kernel feeds to P.V."""
    p = min(math.ldexp(1.0 + mantissa / 2 ** 23, exponent), 1.0)
    x = torch.tensor([p], dtype=torch.float32) * tswa.TC_P_SCALE_F16
    two = split_terms(x, 2, torch.float16)
    assert all(torch.equal(t.half().float(), t) for t in two)
    xd = x.double().item()
    assert abs(two[0].double().item() - xd) <= 2.0 ** -11 * xd
    assert abs((two[0] + two[1]).double().item() - xd) <= 2.0 ** -22 * xd
