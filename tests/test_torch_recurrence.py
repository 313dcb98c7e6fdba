"""Chunked-parallel vs sequential recurrences (Mamba2's SSD, xLSTM's
mLSTM) in the port, each held against ``repro``'s own functions, on the
CPU (the counterpart of ``tests/test_recurrence.py``).

The chunkwise forms are algebraic re-associations of the step-by-step
recurrences and must match them (2e-4 for SSD, 3e-4 for the mLSTM, the
reference's tolerances); the port's forms match the reference's at
float32 rounding.  Also the causal conv with and without a decode state,
one SSD step, the sLSTM scan, the mLSTM state handoff between two
chunked halves, long sequences with extreme gates, and the reference's
behaviour the port mirrors: a multi-position Mamba2 call starts its SSM
from zero whatever state it is given.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba2 as jmb, xlstm as jxl
from repro.models.common import init_params as jinit_params
from repro_torch import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as tmb, xlstm as txl

from _lm_reference import CTX, JCTX, max_err


def _ssd_inputs(seed, b, l, h, p, n, dt_scale=1.0, A=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) * dt_scale)).astype(
        np.float32)
    if A is None:
        A = -np.exp(rng.standard_normal(h) * 0.5)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C)]


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _ssd_sequential(x, dt, A, B, C):
    b, l, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(l):
        state, y = tmb.ssd_step(state, x[:, t], dt[:, t], A, B[:, t],
                                C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("l", [12, 16, 31])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_equals_sequential(chunk, l):
    arrays = _ssd_inputs(100 * chunk + l, 2, l, 3, 4, 5)
    y_seq, s_seq = _ssd_sequential(*_t(arrays))
    y_chk, s_chk = tmb.ssd_chunked(*_t(arrays), chunk)
    np.testing.assert_allclose(y_chk.numpy(), y_seq.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(s_chk.numpy(), s_seq.numpy(), atol=2e-4,
                               rtol=2e-4)
    jy, js = jax.jit(jmb.ssd_chunked, static_argnums=5)(
        *[jnp.asarray(a) for a in arrays], chunk)
    scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
    assert max_err(jy, y_chk) <= 1e-5 * scale
    assert max_err(js, s_chk) <= 1e-5 * max(1.0, float(np.abs(
        np.asarray(js)).max()))


def test_ssd_step_matches_reference():
    x, dt, A, B, C = _ssd_inputs(3, 2, 1, 3, 4, 5)
    state = np.random.default_rng(4).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    js, jy = jmb.ssd_step(jnp.asarray(state), jnp.asarray(x[:, 0]),
                          jnp.asarray(dt[:, 0]), jnp.asarray(A),
                          jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    ts, ty = tmb.ssd_step(*_t([state, x[:, 0], dt[:, 0], A, B[:, 0],
                               C[:, 0]]))
    assert max_err(js, ts) <= 1e-6 and max_err(jy, ty) <= 1e-5


def test_ssd_decay_is_stable_for_long_sequences():
    """No NaN/inf for 512-step sequences with extreme gates (A = -e^3 and
    -e^-6), and the reference's values."""
    arrays = _ssd_inputs(0, 1, 512, 2, 4, 4, dt_scale=3.0,
                         A=-np.exp(np.array([3.0, -6.0])))
    y, s = tmb.ssd_chunked(*_t(arrays), 64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    jy, js = jax.jit(jmb.ssd_chunked, static_argnums=5)(
        *[jnp.asarray(a) for a in arrays], 64)
    assert max_err(jy, y) <= 1e-4 * max(1.0, float(np.abs(jy).max()))
    assert max_err(js, s) <= 1e-4 * max(1.0, float(np.abs(js).max()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, dtype):
    """Four f32 taps summed from zero in tap order, the bias, SiLU, the
    cast; with a decode state prepended (in bf16, as the state is
    stored) and the new state its last K-1 rows."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(5)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 6, 24), (4, 24), (24,)))
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jst = jnp.asarray(st, jnp.bfloat16) if with_state else None
    tst = torch.from_numpy(st).to(torch.bfloat16) if with_state else None
    jy, jnew = jmb._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                jnp.asarray(b, jdt), jst)
    ty, tnew = tmb._causal_conv(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(w).to(tdt),
                                torch.from_numpy(b).to(tdt), tst)
    assert ty.dtype == tdt and tnew.shape == (2, 3, 24)
    assert max_err(jy, ty) <= (1e-6 if dtype == "f32" else 0.0)
    assert max_err(jnew, tnew) == 0.0


def test_mamba_block_ignores_an_incoming_ssm_state_for_a_prompt():
    """Mirrored from the reference: with more than one position the
    chunked path runs from a zero SSM state whatever ``state`` holds
    (the conv state is used); one position runs ``ssd_step`` on it."""
    cfg = get_config("zamba2-7b", reduced=True)
    jcfg = jget_config("zamba2-7b", reduced=True)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jinit_params(
        jax.random.PRNGKey(3), jmb.mamba_param_specs(jcfg)))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    st = tmb.mamba_state_init(cfg, 2, device="cpu")
    busy = {"conv": st["conv"],
            "ssm": torch.from_numpy(rng.standard_normal(
                tuple(st["ssm"].shape)).astype(np.float32))}
    y_zero, _ = tmb.mamba_block(tp, torch.from_numpy(x), cfg, CTX, st)
    y_busy, _ = tmb.mamba_block(tp, torch.from_numpy(x), cfg, CTX, busy)
    assert torch.equal(y_zero, y_busy)
    jbusy = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if k == "conv" else jnp.float32)
        for k, v in busy.items()}
    for l in (5, 1):
        jy, jnew = jax.jit(jmb.mamba_block, static_argnums=(2, 3))(
            jp, jnp.asarray(x[:, :l]), jcfg, JCTX, jbusy)
        ty, tnew = tmb.mamba_block(tp, torch.from_numpy(x[:, :l]), cfg, CTX,
                                   busy)
        scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
        assert max_err(jy, ty) <= 1e-5 * scale, l
        assert max_err(jnew["ssm"], tnew["ssm"]) <= 1e-4 * max(
            1.0, float(np.abs(np.asarray(jnew["ssm"])).max())), l


def _mlstm_inputs(seed, b, l, h, p):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, p)).astype(np.float32)
               for _ in range(3))
    log_i = rng.standard_normal((b, l, h)).astype(np.float32)
    z = rng.standard_normal((b, l, h)) + 2.0
    log_f = (-np.log1p(np.exp(-z))).astype(np.float32)
    return [q, k, v, log_i, log_f]


@pytest.mark.parametrize("l", [8, 12, 17])
@pytest.mark.parametrize("chunk", [4, 8])
def test_mlstm_chunked_equals_sequential(chunk, l):
    """Ragged lengths pad log_i with -1e30 from an m = -inf state: no
    inf - inf anywhere.  States agree up to the stabilizer frame, so
    C * exp(m) is compared."""
    arrays = _mlstm_inputs(10 * chunk + l, 2, l, 2, 4)
    y_seq, (C_s, n_s, m_s) = txl.mlstm_sequential(*_t(arrays))
    y_chk, (C_c, n_c, m_c) = txl.mlstm_chunked(*_t(arrays), chunk)
    assert bool(torch.isfinite(y_chk).all()) and bool(
        torch.isfinite(m_c).all())
    np.testing.assert_allclose(y_chk.numpy(), y_seq.numpy(), atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(
        (C_c * torch.exp(m_c)[..., None, None]).numpy(),
        (C_s * torch.exp(m_s)[..., None, None]).numpy(), atol=3e-4,
        rtol=3e-4)
    J = [jnp.asarray(a) for a in arrays]
    jy, _ = jax.jit(jxl.mlstm_chunked, static_argnums=5)(*J, chunk)
    jy2, _ = jax.jit(jxl.mlstm_sequential)(*J)
    scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
    assert max_err(jy, y_chk) <= 1e-5 * scale
    assert max_err(jy2, y_seq) <= 1e-5 * scale


def test_mlstm_state_continuation():
    """Two chunked halves with the state handed over == one full pass."""
    arrays = _mlstm_inputs(7, 1, 16, 2, 4)
    T = _t(arrays)
    y_full, _ = txl.mlstm_chunked(*T, 4)
    y1, st = txl.mlstm_chunked(*[a[:, :8] for a in T], 4)
    y2, _ = txl.mlstm_chunked(*[a[:, 8:] for a in T], 4, state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=3e-4, rtol=3e-4)
    J = [jnp.asarray(a) for a in arrays]
    _, jst = jxl.mlstm_chunked(*[a[:, :8] for a in J], 4)
    jy2, _ = jxl.mlstm_chunked(*[a[:, 8:] for a in J], 4, state=jst)
    assert max_err(jy2, y2) <= 1e-5 * max(1.0, float(np.abs(jy2).max()))


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_reference(with_state):
    """The four gates' products side by side against the reference's
    four, from the zero state (m = -inf) and from a prefill's state."""
    jcfg = jget_config("xlstm-125m", reduced=True)
    jp = jinit_params(jax.random.PRNGKey(8), jxl.slstm_param_specs(jcfg))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    xn = np.random.default_rng(9).standard_normal((2, 7, jcfg.d_model))
    xn = xn.astype(np.float32)
    jst = tst = None
    if with_state:
        _, jst = jxl.slstm_scan(jp, jnp.asarray(xn[:, :4]))
        _, tst = txl.slstm_scan(tp, torch.from_numpy(xn[:, :4]))
    jy, jnew = jax.jit(jxl.slstm_scan)(jp, jnp.asarray(xn[:, 4:]), jst)
    ty, tnew = txl.slstm_scan(tp, torch.from_numpy(xn[:, 4:]), tst)
    assert max_err(jy, ty) <= 1e-5
    for a, b in zip(jnew, tnew):
        assert max_err(a, b) <= 1e-4 * max(1.0, float(np.abs(a).max()))
