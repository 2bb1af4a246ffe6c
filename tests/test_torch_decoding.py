"""Port of the batched decoders against the JAX functions on a shared
deterministic step table.

The "model" is a lookup: the carry is an integer state, the next state
is ``(7·state + token) mod P`` and the logits are ``table[state]``, so
both frameworks see bit-identical logits and every difference would be
the decoders'.  Tokens must be equal and scores within rtol 1e-5 (the
logsumexp is an f32 sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_captioning_tpu.ops import decoding as jdec
from vae_captioning_torch.ops import decoding as tdec
from vae_captioning_torch.ops.fused_logits_topk import stable_top_k

V, P = 12, 37
BOS, EOS = 1, 2


def _table(seed, eos_shift=0.0):
    rng = np.random.default_rng(seed)
    table = rng.normal(0.0, 2.0, size=(P, V)).astype(np.float32)
    table[:, EOS] += eos_shift
    return table


def _jax_step(table):
    t = jnp.asarray(table)

    def step_fn(carry, tokens):
        state = (carry * 7 + tokens) % P
        return state, t[state]

    return step_fn


def _torch_step(table):
    t = torch.from_numpy(table)

    def step_fn(carry, tokens):
        state = (carry * 7 + tokens) % P
        return state, t[state]

    return step_fn


def _torch_topk_step(table, k):
    """The fused step form the port's beam search takes."""
    step = _torch_step(table)

    def fn(carry, tokens):
        carry, logits = step(carry, tokens)
        vals, idx = stable_top_k(logits, k)
        return carry, vals, idx, torch.logsumexp(logits, dim=-1)

    return fn


def _init(B, seed=0):
    return np.random.default_rng(seed).integers(0, P, size=B).astype(np.int32)


def _beams(table, init, K, max_len, early_exit):
    """JAX through its logits step_fn path, the port through its fused
    step form, on the same table."""
    kw = dict(beam_size=K, bos_id=BOS, eos_id=EOS, max_len=max_len,
              len_norm_f=0.7, early_exit=early_exit)
    j = jdec.beam_search(_jax_step(table), jnp.asarray(init), len(init), **kw)
    t = tdec.beam_search(None, torch.from_numpy(init).long(), len(init),
                         step_topk_fn=_torch_topk_step(table, K), **kw)
    return j, t


def _assert_beams_equal(j, t):
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                               rtol=1e-5)


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 10])
def test_beam_search_all_beams_match_jax(K):
    table = _table(seed=K)
    j, t = _beams(table, _init(6, seed=K), K, max_len=8, early_exit=True)
    assert t.tokens.shape == (6, K, 8)
    _assert_beams_equal(j, t)


def test_partial_fallback_matches_jax():
    """EOS far below the p < 1e-12 floor: nothing completes, every image
    falls back to its partial captions with raw log-probs."""
    table = _table(seed=3, eos_shift=-80.0)
    j, t = _beams(table, _init(5), 3, max_len=6, early_exit=True)
    _assert_beams_equal(j, t)
    assert (t.tokens.numpy() != EOS).all()
    assert t.steps == 6


def test_early_exit_matches_full_run_and_jax():
    """A likely EOS ends every image early; the bound-based exit must give
    the output of running all max_len steps."""
    table = _table(seed=5, eos_shift=4.0)
    init = _init(6, seed=5)
    j_early, t_early = _beams(table, init, 3, max_len=20, early_exit=True)
    j_full, t_full = _beams(table, init, 3, max_len=20, early_exit=False)
    assert t_early.steps < 20 and t_full.steps == 20
    _assert_beams_equal(j_early, t_early)
    _assert_beams_equal(j_full, t_full)
    np.testing.assert_array_equal(t_early.tokens.numpy(),
                                  t_full.tokens.numpy())
    np.testing.assert_array_equal(t_early.scores.numpy(),
                                  t_full.scores.numpy())


@pytest.mark.parametrize("eos_shift", [0.0, 3.0])
@pytest.mark.parametrize("early_exit", [True, False])
def test_greedy_matches_jax(eos_shift, early_exit):
    table = _table(seed=7, eos_shift=eos_shift)
    init = _init(9, seed=7)
    kw = dict(bos_id=BOS, eos_id=EOS, max_len=10, early_exit=early_exit)
    want = np.asarray(jdec.sample_decode(_jax_step(table), jnp.asarray(init),
                                         9, **kw))
    topk = _torch_topk_step(table, 1)

    def argmax_fn(carry, tokens):
        carry, _, idx, _ = topk(carry, tokens)
        return carry, idx[:, 0]

    got = tdec.sample_decode(None, torch.from_numpy(init).long(), 9,
                             step_argmax_fn=argmax_fn, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    if early_exit and eos_shift > 0:
        assert got.steps < 10


def test_tokens_to_text_matches_jax():
    idx2word = {i: f"w{i}" for i in range(V)}
    for row in ([3, 4, 0, 5, EOS, 6], [BOS, 3, BOS, 7], [0, 0], [EOS, 3]):
        assert (tdec.tokens_to_text(row, idx2word, EOS, BOS)
                == jdec.tokens_to_text(row, idx2word, EOS, BOS))
