"""Where one training step of the port and of the reference part by
rounding alone (``tests/test_torch_train.py`` holds the rest).

* At the reference's own (wide) init, zamba2's, xLSTM's and Whisper's
  grads part by up to 2.1e-4 of a leaf's max (measured: zamba2 1.1e-4,
  xLSTM 2.1e-4 in v and 1.3e-4 in m, Whisper 1.8e-4; their grad norms by
  up to 3.5e-5 relative, xLSTM's 2.2e-5): the reference's fan-in rule
  draws 3-D projections wide enough to amplify last-bit differences
  (``tests/_lm_reference.py``; at their true fan-in all three fall
  within 1.5e-5).  Held within 5e-4 (metrics 2e-4).
* In bfloat16, qwen3's grads against the reference run op by op
  (``jax.disable_jit()``; XLA's fused bf16 skips roundings the code asks
  for): measured, the loss equal to the bit and one element in 2,048 of
  one leaf one bf16 ulp apart (1.1e-4 of the leaf's max).  Held within
  1e-3 of each leaf's max; every grad comes back in bfloat16, as
  ``jax.value_and_grad`` returns it.
"""
import jax
import numpy as np
import pytest
import torch

from _lm_reference import (CTX, JCTX, TRAIN_OPT, as_jax, as_torch,
                           assert_step_matches, inputs, one_step, pair)
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step

REFERENCE_INIT_RTOL = 5e-4
REFERENCE_INIT_METRIC_RTOL = 2e-4
BF16_RTOL = 1e-3


@pytest.mark.parametrize("arch_id", ("zamba2-7b", "xlstm-125m",
                                     "whisper-tiny"))
def test_train_step_at_reference_init(arch_id):
    ref, port = one_step(arch_id, False)
    assert_step_matches(ref, port, REFERENCE_INIT_RTOL,
                        REFERENCE_INIT_METRIC_RTOL)


def test_bf16_grads_match_reference_op_by_op():
    p = pair("qwen3-14b", "bf16")
    batch = inputs(p.cfg, 2, 16, seed=3)
    grad = jax.value_and_grad(
        lambda pp, bb: p.jarch.loss(pp, bb, p.jcfg, JCTX), has_aux=True)
    with jax.disable_jit():
        (jloss, _), jgrads = grad(p.jparams, as_jax(batch))
    step = make_train_step(p.arch, AdamWConfig(**TRAIN_OPT), CTX)
    loss, _, grads = step.grads_of(p.params, as_torch(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    got = list(tree_leaves(grads, torch.is_tensor))
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = [np.asarray(g, np.float32) for g in jax.tree.leaves(jgrads)]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        assert float(np.abs(w - g.float().numpy()).max()) <= \
            BF16_RTOL * float(np.abs(w).max())
