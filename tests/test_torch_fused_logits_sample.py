"""Port of the fused Gumbel-max sampler and of temperature sampling in the
decode loop.

The TPU kernel's on-chip PRNG has no CPU lowering (its
``fused_logits_sample`` raises even in interpret mode) and its bits
cannot be reproduced, so the port's sampler is held to:

* its noise stream: Philox bits deterministic per (seed, step), other
  for another seed, step, row or column, and independent of how the rows
  are batched (rows [a:b] of a draw equal the draw of those rows alone);
* its law: over 100,000 draws at V = 20 the empirical distribution lies
  within total variation 0.02 of ``softmax(logits · (1/T))``, the logits
  from the JAX package's ``fused_logits_top_k_xla`` maths on the same
  h, W, b (the noise of 100,000 draws over 20 categories alone is about
  0.006);
* the JAX decode loop: ``sample_decode(mode="sample")`` with the same
  deterministic sampler injected on both sides gives the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_captioning_tpu.ops import decoding as jdec
from vae_captioning_tpu.ops import fused_logits_topk as jfl
from vae_captioning_torch import _ext
from vae_captioning_torch.ops import decoding as tdec
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_sample, fused_logits_sample_plain, gumbel_noise, sample_bits,
    sample_scores)
from vae_captioning_torch.ops.fused_z import philox_bits

TV_LIMIT = 0.02


def _head(H, V, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, H)).astype(np.float32),
            rng.normal(0, 0.5, size=(H, V)).astype(np.float32),
            rng.normal(0, 0.5, size=(V,)).astype(np.float32))


def test_bits_are_deterministic_and_distinct_per_key_row_and_column():
    bits = sample_bits(7, 3, 6, 50)
    assert bits.shape == (6, 50) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    assert torch.equal(bits, sample_bits(7, 3, 6, 50))
    for other in (sample_bits(8, 3, 6, 50), sample_bits(7, 4, 6, 50)):
        assert float((other == bits).float().mean()) < 0.01
    assert len(set(bits.flatten().tolist())) == bits.numel()
    # not the z stream of the same key (fused_z counts with 0 in the last
    # counter word, the sampler with its tag)
    z = philox_bits(7, 3, 6, 1, 50)[:, 0]
    assert float((z == bits).float().mean()) < 0.01
    # columns past a multiple of 4 continue the stream
    np.testing.assert_array_equal(sample_bits(7, 3, 6, 53)[:, :50], bits)


def test_rows_of_a_draw_equal_the_draw_of_those_rows_alone():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(40, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 300)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))
    full = fused_logits_sample_plain(h, w, b, seed=11, step=2, temperature=0.8)
    assert full.dtype == torch.int32 and full.shape == (40,)
    for a, e in ((0, 7), (13, 40), (21, 22)):
        part = fused_logits_sample_plain(h[a:e], w, b, 11, 2, 0.8, row0=a)
        assert torch.equal(part, full[a:e])
    assert not torch.equal(full, fused_logits_sample_plain(h, w, b, 11, 3, 0.8))


@pytest.mark.parametrize("temperature", [0.7, 1.0, 1.5])
def test_law_matches_softmax_of_the_jax_logits(temperature):
    H, V, draws = 32, 20, 100_000
    h, w, b = _head(H, V, seed=int(temperature * 10))
    # every logit, through the JAX reference's top-V
    vals, idx, _ = jfl.fused_logits_top_k_xla(jnp.asarray(h), jnp.asarray(w),
                                              jnp.asarray(b), V)
    logits = np.empty(V, np.float32)
    logits[np.asarray(idx[0])] = np.asarray(vals[0])
    scaled = logits * np.float32(1.0 / temperature)
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    hs = torch.from_numpy(np.repeat(h, draws, axis=0))
    tokens = fused_logits_sample(hs.to(torch.bfloat16),
                                 torch.from_numpy(w).to(torch.bfloat16),
                                 torch.from_numpy(b), seed=123, step=4,
                                 temperature=temperature)
    freq = np.bincount(tokens.numpy(), minlength=V) / draws
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv < TV_LIMIT, f"T={temperature}: TV {tv:.4f}"
    assert p.max() < 0.6        # a law worth testing: no one token dominates


def test_scores_are_logits_times_inverse_temperature_plus_gumbel():
    """Multiplied by f32(1/T), not divided by T, as the TPU kernel does;
    G = -log(-log(u)) with u clipped to [1e-7, 1 - 1e-7]."""
    h, w, b = _head(32, 9, seed=3)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b))
    hf = args[0].to(torch.bfloat16).float()
    logits = hf @ args[1].to(torch.bfloat16).float() + args[2]
    g = gumbel_noise(5, 0, 1, 9)
    for temperature in (1.0, 0.3):
        inv = torch.tensor(1.0 / temperature, dtype=torch.float32)
        torch.testing.assert_close(
            sample_scores(*args, seed=5, step=0, temperature=temperature),
            logits * inv + g, rtol=0, atol=0)
    assert bool(((g > -3.0) & (g < 17.0)).all())


def test_wrapper_takes_plain_version_on_cpu_and_checks_keys():
    h, w, b = _head(32, 40, seed=4)
    args = (torch.from_numpy(np.repeat(h, 5, 0)).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b))
    before = _ext.LAUNCHES["fused_logits_sample"]
    got = fused_logits_sample(*args, 9, 1, 1.3)
    assert _ext.LAUNCHES["fused_logits_sample"] == before
    assert torch.equal(got, fused_logits_sample_plain(*args, 9, 1, 1.3))
    with pytest.raises(ValueError, match="32-bit"):
        fused_logits_sample(*args, -1, 0)
    with pytest.raises(ValueError, match="32-bit"):
        fused_logits_sample(*args, 0, 2 ** 32)


# ----------------------------------------------------------------------
# the decode loop
# ----------------------------------------------------------------------

V, P = 12, 37
BOS, EOS = 1, 2
MAX_LEN = 10


def _tables(seed):
    """A lookup-table model: state' = (7·state + token) mod P.  The
    injected sampler takes argmax(table[state'] + noise[step, state']),
    deterministic; BOS is favoured in some states, so it is drawn mid
    caption."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0.0, 1.0, size=(P, V)).astype(np.float32)
    table[::5, BOS] += 3.0
    noise = rng.gumbel(size=(MAX_LEN, P, V)).astype(np.float32)
    return table, noise


def _jax_sampler(table, noise, rng):
    """(carry, tokens, step_rng) → (carry, next); the step index is found
    by matching the step key against the loop's own split of ``rng``."""
    keys = jax.random.split(rng, MAX_LEN)
    t_tab, n_tab = jnp.asarray(table), jnp.asarray(noise)

    def fn(carry, tokens, step_rng):
        state = (carry * 7 + tokens) % P
        t = jnp.argmax(jnp.all(keys == step_rng, axis=-1))
        return state, jnp.argmax(t_tab[state] + n_tab[t, state], axis=-1)

    return fn


def _torch_sampler(table, noise):
    t_tab, n_tab = torch.from_numpy(table), torch.from_numpy(noise)

    def fn(carry, tokens, step):
        state = (carry * 7 + tokens) % P
        return state, torch.argmax(t_tab[state] + n_tab[step, state], dim=-1)

    return fn


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_decode_loop_matches_jax(seed, early_exit):
    table, noise = _tables(seed)
    init = np.random.default_rng(seed).integers(0, P, size=16).astype(np.int32)
    rng = jax.random.PRNGKey(seed)
    kw = dict(bos_id=BOS, eos_id=EOS, max_len=MAX_LEN, early_exit=early_exit)
    want = np.asarray(jdec.sample_decode(
        None, jnp.asarray(init), 16, mode="sample", rng=rng,
        step_sample_fn=_jax_sampler(table, noise, rng), **kw))
    got = tdec.sample_decode(None, torch.from_numpy(init).long(), 16,
                             mode="sample",
                             step_sample_fn=_torch_sampler(table, noise), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    tokens = got.tokens.numpy()
    assert (tokens == BOS).any(), "no BOS drawn mid caption"
    for row in tokens:
        ends = np.flatnonzero(row == EOS)
        if ends.size:
            assert not row[ends[0] + 1:].any()
    if early_exit and (tokens == EOS).any(axis=1).all():
        assert got.steps < MAX_LEN


def test_sample_decode_step_fn_form_draws_from_softmax():
    """Without a fused form, sampling draws from softmax(logits / T) with
    the caller's generator: one step of 20,000 lanes from one state."""
    table, _ = _tables(3)
    t_tab = torch.from_numpy(table)

    def step_fn(carry, tokens):
        state = (carry * 7 + tokens) % P
        return state, t_tab[state]

    lanes, temperature = 20_000, 1.4
    init = torch.zeros(lanes, dtype=torch.long)
    got = tdec.sample_decode(step_fn, init, lanes, bos_id=BOS, eos_id=EOS,
                             max_len=1, mode="sample", temperature=temperature,
                             generator=torch.Generator().manual_seed(0))
    p = torch.softmax(t_tab[(7 * 0 + BOS) % P] / temperature, dim=-1).numpy()
    freq = np.bincount(got.tokens[:, 0].numpy(), minlength=V) / lanes
    assert 0.5 * np.abs(freq - p).sum() < TV_LIMIT
    again = tdec.sample_decode(step_fn, init, lanes, bos_id=BOS, eos_id=EOS,
                               max_len=1, mode="sample",
                               temperature=temperature,
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(got.tokens, again.tokens)
    with pytest.raises(ValueError, match="needs step_fn"):
        tdec.sample_decode(None, init, lanes, bos_id=BOS, eos_id=EOS,
                           max_len=1, mode="sample")
