"""One training step of the port (``repro_torch.train``) against the
reference's, and the port's counterparts of the reference's trainer tests.

Both packages hold the same reduced parameters (``tests/_lm_reference.py``
``pair``: the reference's init carried across) and take the same seeded
batch.  The reference's ``make_train_step`` runs jitted, the port's
eagerly, both from fresh AdamW state in f32.  Grads are compared through
the first moment after the step, m = (1 - b1) * clip * g, and the grad
norm; the params are not (Adam's first step moves an entry by about
lr * sign(g), so entries with g near 0 may part).  Each m (and v) leaf
is held within 1e-4 of its largest entry, plus 1e-8 of the largest entry
of the whole tree (``_lm_reference.assert_step_matches``).

zamba2, xLSTM and Whisper take their weights at their true fan-in
(``pair(..., fan_in=True)``): at the reference's own init the wide
projections amplify last-bit differences (``_lm_reference``;
``tests/test_torch_train_rounding.py`` holds them there, and qwen3 in
bfloat16).  Remat on and off are bit-identical in the port.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from _lm_reference import (CTX, TRAIN_OPT, as_torch, assert_step_matches,
                           inputs, one_step)
from repro_torch.configs import get_config
from repro_torch.models import make_arch
from repro_torch.models.common import init_params, tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import (InjectedFailure, Trainer, TrainLoopConfig,
                               make_train_step)

FAMILIES = ("qwen3-14b", "olmoe-1b-7b", "zamba2-7b", "xlstm-125m",
            "whisper-tiny")
FAN_IN = {"zamba2-7b", "xlstm-125m", "whisper-tiny"}
F32_RTOL = 1e-4


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_train_step_matches_reference_f32(arch_id):
    ref, port = one_step(arch_id, arch_id in FAN_IN)
    assert_step_matches(ref, port, F32_RTOL)


def test_accumulation_matches_reference_scan():
    """accum_steps=2: microbatch i is rows i*B/2 .. (i+1)*B/2 - 1, grads
    summed in f32 in order and halved, the loss the mean of the two."""
    ref, port = one_step("qwen3-14b", False, accum=2, rows=4)
    assert_step_matches(ref, port, F32_RTOL)
    one_ref, _ = one_step("qwen3-14b", False, accum=1, rows=4)
    # the same rows in one batch: the same loss up to rounding, not the
    # same number
    assert float(port[0]["loss_total"]) == pytest.approx(
        float(one_ref[0]["loss_total"]), rel=1e-5)


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_remat_is_bit_identical(arch_id):
    base = get_config(arch_id, reduced=True)
    batch = as_torch(inputs(base, 2, 16, seed=5))    # the params' bf16
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        arch = make_arch(cfg)
        params = init_params(torch.Generator().manual_seed(0),
                             arch.param_specs(cfg), device="cpu")
        step = make_train_step(arch, AdamWConfig(**TRAIN_OPT), CTX)
        loss, _, grads = step.grads_of(params, batch)
        out.append((loss, list(tree_leaves(grads, torch.is_tensor))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# --- the reference's trainer tests (tests/test_substrate.py,
# tests/test_system.py), on the port ------------------------------------
def _trainer(tmp, arch_id="yi-9b", **kw):
    cfg = get_config(arch_id, reduced=True)
    arch = make_arch(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    lc = TrainLoopConfig(ckpt_dir=str(tmp), log_every=2, **kw)
    return Trainer(arch, opt, lc, device="cpu")


def test_trainer_restart_after_injected_failure(tmp_path):
    tr = _trainer(tmp_path, total_steps=10, ckpt_every=4,
                  inject_failure_at=7)
    with pytest.raises(InjectedFailure):
        tr.run()
    tr.ckpt.wait()
    # "new process": resumes from step 4 and finishes
    tr2 = _trainer(tmp_path, total_steps=10, ckpt_every=4)
    hist = tr2.run()
    assert tr2.step == 10 and hist[-1]["step"] == 10
    assert any(e["kind"] == "resume" and e["step"] == 4
               for e in tr2.events)


def test_trainer_resume_replays_same_data_and_state(tmp_path):
    """Stateless data: the resumed run takes the batch an uninterrupted
    run takes at that step, and ends in the same state."""
    straight = _trainer(tmp_path / "a", total_steps=6, ckpt_every=100)
    straight.run()
    tr = _trainer(tmp_path / "b", total_steps=6, ckpt_every=3,
                  inject_failure_at=4)
    with pytest.raises(InjectedFailure):
        tr.run()
    tr.ckpt.wait()
    tr2 = _trainer(tmp_path / "b", total_steps=6, ckpt_every=3)
    assert tr2.try_resume() and tr2.step == 3
    assert tr2.data_cfg == straight.data_cfg
    tr2.run()
    for a, b in zip(tree_leaves(straight._state_tree(), torch.is_tensor),
                    tree_leaves(tr2._state_tree(), torch.is_tensor)):
        assert torch.equal(a.detach(), b.detach())


def test_straggler_watchdog_records_events(tmp_path):
    tr = _trainer(tmp_path, total_steps=1, ckpt_every=100,
                  watchdog_min_history=2, watchdog_factor=1.0)
    tr.init_state()
    tr._step_times = [1e-9] * 8      # force an impossible deadline
    tr.run_step()
    assert any(e["kind"] == "straggler" for e in tr.events)


def test_trainer_with_compression_and_8bit_state_resumes(tmp_path):
    """The error-feedback buffers and the int8 moments go through the
    checkpoint and come back bitwise."""
    cfg = get_config("olmoe-1b-7b", reduced=True)
    arch = make_arch(dataclasses.replace(cfg, accum_steps=2))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50,
                      quantize_state=True)
    lc = TrainLoopConfig(total_steps=3, ckpt_every=3, log_every=1,
                         ckpt_dir=str(tmp_path), grad_compression=True)
    tr = Trainer(arch, opt, lc, device="cpu")
    hist = tr.run()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert tr.err is not None
    tr2 = Trainer(arch, opt, lc, device="cpu")
    assert tr2.try_resume() and tr2.step == 3
    for a, b in zip(tree_leaves(tr._state_tree(), torch.is_tensor),
                    tree_leaves(tr2._state_tree(), torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


def test_training_and_serving_substrate(tmp_path):
    """Train a tiny model, checkpoint, resume, and serve from it (the
    reference's tests/test_system.py on the port)."""
    cfg = get_config("qwen3-14b", reduced=True)
    arch = make_arch(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    lc = TrainLoopConfig(total_steps=6, ckpt_every=3, log_every=2,
                         ckpt_dir=str(tmp_path))
    tr = Trainer(arch, opt, lc, device="cpu")
    hist = tr.run()
    assert tr.step == 6 and np.isfinite(hist[-1]["loss"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000006"]
    tr2 = Trainer(arch, opt, lc, device="cpu")
    assert tr2.try_resume() and tr2.step == 6
    eng = ServeEngine(arch, tr2.params, max_len=48, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32)
    toks = eng.generate({"tokens": prompts}, n_tokens=4)
    assert toks.shape == (2, 4)
    assert int(toks.max()) < cfg.vocab
