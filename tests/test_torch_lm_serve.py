"""``repro_torch.serve.ServeEngine`` against ``repro``'s, on the CPU.

Greedy generation on reduced qwen3-14b and gemma2-27b in float32 (the
reference's engine jitted, as it runs), and gemma2-27b in bfloat16 (op
by op: ``tests/_lm_reference.py``), from the same parameters and
prompt.  With random weights two logits can tie to within rounding, and
the packages may then pick different tokens, after which their
sequences part.  So a row's tokens are held equal up to its first step
where the reference's top-2 logit gap is at most twice the logit
tolerance, and the rows must hold enough such steps between them.  The
reference's logits are recorded from its own engine.  Also the
``n_tokens`` contract, seeded temperature sampling and a ``cuda``-marked
run on the card against the host.
"""
import pytest
import torch

from repro_torch.serve import ServeEngine

from _lm_reference import (ATOL, as_jax, as_torch, inputs, pair,
                           reference_generate, tokens_held)
from _serve_reference import jserve  # noqa: F401

N_TOKENS = 6


@pytest.mark.parametrize("arch_id,dtype", [("qwen3-14b", "f32"),
                                            ("gemma2-27b", "f32"),
                                            ("gemma2-27b", "bf16")])
def test_greedy_generate_matches_reference(jserve, arch_id, dtype):
    p = pair(arch_id, dtype)
    batch = inputs(p.cfg, 4, 10, seed=21)
    want, logits = reference_generate(jserve, p, as_jax(batch), dtype,
                                      N_TOKENS)
    got = ServeEngine(p.arch, p.params, max_len=32,
                      device="cpu").generate(as_torch(batch), N_TOKENS)
    assert got.dtype == torch.int32 and got.shape == want.shape
    held = tokens_held(got, want, logits, ATOL[dtype])
    # bf16 logits are multiples of 2**-6 near 3: near-ties are common
    assert held >= (want.size // 2 if dtype == "f32" else want.shape[0])


def test_n_tokens_contract():
    """``n_tokens < 1`` raises; ``n_tokens = 1`` is the prefill's argmax
    (no decode step)."""
    p = pair("qwen3-14b", "f32")
    eng = ServeEngine(p.arch, p.params, max_len=32, device="cpu")
    batch = as_torch(inputs(p.cfg, 2, 10, seed=22))
    for n in (0, -1):
        with pytest.raises(ValueError, match="n_tokens"):
            eng.generate(batch, n)
    with torch.inference_mode():
        _, _, logits = p.arch.prefill(p.params, batch, p.cfg, eng.ctx,
                                      max_len=32)
    one = eng.generate(batch, 1)
    assert one.tolist() == torch.argmax(logits[:, -1], -1)[:, None].tolist()
    # numpy prompts are taken as they are
    np_batch = {k: v.numpy() for k, v in batch.items()}
    assert torch.equal(eng.generate(np_batch, 3), eng.generate(batch, 3))


def test_temperature_sampling_follows_the_generator():
    p = pair("gemma2-27b", "f32")
    eng = ServeEngine(p.arch, p.params, max_len=32, device="cpu")
    batch = as_torch(inputs(p.cfg, 2, 10, seed=23))

    def draw(seed):
        return eng.generate(batch, N_TOKENS, temperature=2.0,
                            generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(5), draw(5), draw(6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < p.cfg.vocab
    # the default generator is seed 0
    assert torch.equal(eng.generate(batch, N_TOKENS, temperature=2.0),
                       draw(0))


@pytest.mark.cuda
def test_generate_on_the_card_matches_the_host():
    """Reduced qwen3-14b in float32 (TF32 off): the card's tokens have the
    host's shape and its first greedy token."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    p = pair("qwen3-14b", "f32")
    batch = as_torch(inputs(p.cfg, 3, 10, seed=24))
    host = ServeEngine(p.arch, p.params, max_len=32, device="cpu")
    card = ServeEngine(p.arch, p.params, max_len=32)
    assert card.device.type == "cuda"
    want = host.generate(batch, N_TOKENS)
    got = card.generate(batch, N_TOKENS).cpu()
    assert torch.equal(got[:, 0], want[:, 0])
    assert got.shape == want.shape
