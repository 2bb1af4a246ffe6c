"""Port of the int8 logits + top-k + logsumexp: the quantisers against
the JAX package's, bit for bit; the plain version (what the wrapper runs
on CPU tensors) against the JAX int8 Pallas kernel in interpret mode and
against ``fused_logits_top_k_int8_xla``; and the int8 top-1 against the
bf16 path.

The int32 product is exact on both sides, so indices must be equal and
values within rtol 1e-6 (only the dequantisation's roundings could
differ); the logsumexp is an f32 sum in another order (rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import fused_logits_topk as jfl
from vae_captioning_torch import _ext
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_top_k_int8, fused_logits_top_k_int8_plain,
    fused_logits_top_k_plain, quantize_logits_weights, quantize_rows)


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfl.pl, "pallas_call", patched)
    # a fresh jit of the un-jitted function, traced under the patch
    yield jax.jit(jfl.fused_logits_top_k_int8.__wrapped__,
                  static_argnames="k")


def _weights(H, V, seed):
    """Normals and a zero column (its scale floors at 1e-12)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(H, V)).astype(np.float32)
    w[:, 3] = 0.0
    return w


@pytest.mark.parametrize("H,V", [(64, 3840), (128, 4000), (32, 7)])
def test_quantize_logits_weights_matches_jax(H, V):
    w = _weights(H, V, seed=H + V)
    wq, ws = quantize_logits_weights(torch.from_numpy(w))
    jwq, jws = jfl.quantize_logits_weights(jnp.asarray(w))
    assert wq.dtype == torch.int8 and ws.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    assert float(ws[3]) == np.float32(1e-12)


@pytest.mark.parametrize("M,H", [(256, 64), (300, 128), (5, 512)])
def test_quantize_rows_matches_jax(M, H):
    rng = np.random.default_rng(M)
    h = np.tanh(rng.normal(size=(M, H))).astype(np.float32)
    h[1] = 0.0                                  # an all-zero row
    h[2, :4] = [1.0, 0.5 / 127, 1.5 / 127, -2.5 / 127]   # exact halves
    hq, hs = quantize_rows(torch.from_numpy(h))
    jhq, jhs = jfl._quantize_rows(jnp.asarray(h))
    np.testing.assert_array_equal(hq.numpy(), np.asarray(jhq))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(jhs))
    assert hq[2, :4].tolist() == [127, 0, 2, -2]


# the shapes of tests/test_fused_logits_topk.py's int8 cases, then k = 1
# and k = 10 (the greedy and the paper's beam)
@pytest.mark.parametrize("shape_k", [
    ((256, 64, 3840), 3),
    ((300, 128, 4000), 5),
    ((8, 64, 7680), 1),
    ((512, 128, 4096), 10),
])
def test_plain_matches_jax_int8_kernel(interpreted, shape_k):
    (M, H, V), k = shape_k
    rng = np.random.default_rng(M + k)
    h = rng.normal(size=(M, H)).astype(np.float32)
    w = rng.normal(size=(H, V)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    wq, ws = quantize_logits_weights(torch.from_numpy(w))
    vals, idx, lse = fused_logits_top_k_int8_plain(
        torch.from_numpy(h), wq, ws, torch.from_numpy(b), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    jargs = (jnp.asarray(h), jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()),
             jnp.asarray(b))
    for want in (interpreted(*jargs, k=k),
                 jfl.fused_logits_top_k_int8_xla(*jargs, k)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(vals.numpy(), np.asarray(want[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want[2]),
                                   rtol=1e-5)


def test_int8_agreement_with_the_bf16_path():
    """Quantisation is approximate by design: on a random logits head the
    int8 top-1 must agree with the bf16 path in every row whose top-2
    margin is well above the quantisation error, and in over 90% of all
    rows (tests/test_fused_logits_topk.py's rule)."""
    M, H, V = 128, 64, 1000
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.5, size=(H, V)).astype(np.float32))
    b = torch.zeros(V)
    exact_v, exact_i, _ = fused_logits_top_k_plain(h, w, b, 2)
    _, q_i, _ = fused_logits_top_k_int8_plain(h, *quantize_logits_weights(w),
                                              b, 3)
    agree = (exact_i[:, 0] == q_i[:, 0]).numpy()
    margin = (exact_v[:, 0] - exact_v[:, 1]).numpy()
    big_margin = margin > 0.05 * np.abs(exact_v[:, 0].numpy())
    assert agree[big_margin].all(), "int8 flipped a well-separated top-1"
    assert agree.mean() > 0.9, f"top-1 agreement only {agree.mean():.2f}"


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=(12, 64)).astype(np.float32))
    wq, ws = quantize_logits_weights(
        torch.from_numpy(rng.normal(size=(64, 300)).astype(np.float32)))
    b = torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))
    before = _ext.LAUNCHES["fused_logits_top_k_int8"]
    got = fused_logits_top_k_int8(h, wq, ws, b, 4)
    assert _ext.LAUNCHES["fused_logits_top_k_int8"] == before
    for a, r in zip(got, fused_logits_top_k_int8_plain(h, wq, ws, b, 4)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
