"""Port of the fused LSTM decode step: its plain version (what the
wrapper runs on CPU tensors) against the JAX kernel in Pallas interpret
mode and against the JAX reference ``fused_lstm_step_xla``.

Tolerance: atol = rtol = 1e-5, for f32 sums taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import fused_lstm_step as jfs
from vae_captioning_torch import _ext
from vae_captioning_torch.ops.fused_lstm_step import (fused_lstm_step,
                                                      fused_lstm_step_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfs.pl, "pallas_call", patched)
    yield jfs.fused_lstm_step.__wrapped__  # un-jitted so the patch applies


def _inputs(M, H, E, V, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, size=M).astype(np.int32)
    c = rng.normal(size=(M, H)).astype(np.float32)
    h = rng.normal(size=(M, H)).astype(np.float32)
    embed = rng.normal(size=(V, E)).astype(np.float32)
    w = rng.normal(0, 0.3, size=(E + H, 4 * H)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(4 * H,)).astype(np.float32)
    return tokens, c, h, embed, w, b


def _port(tokens, c, h, embed, w, b):
    # the port gathers bf16 rows outside the kernel, as the TPU path does
    x = torch.from_numpy(embed).to(torch.bfloat16)[torch.from_numpy(tokens).long()]
    return fused_lstm_step_plain(x, torch.from_numpy(c), torch.from_numpy(h),
                                 torch.from_numpy(w).to(torch.bfloat16),
                                 torch.from_numpy(b))


@pytest.mark.parametrize("shape", [
    (128, 64, 32, 512),    # exact JAX block multiple
    (200, 128, 64, 250),   # ragged rows
    (8, 256, 128, 77),     # tiny rows, odd vocab
    (37, 32, 32, 64),      # ragged rows at the test model's widths
])
def test_plain_matches_jax_kernel_and_reference(interpreted, shape):
    M, H, E, V = shape
    args = _inputs(M, H, E, V, seed=sum(shape))
    nc, nh = _port(*args)
    assert nc.shape == nh.shape == (M, H) and nc.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    for want_c, want_h in (interpreted(*jargs, forget_bias=1.0),
                           jfs.fused_lstm_step_xla(*jargs, forget_bias=1.0)):
        np.testing.assert_allclose(nc.numpy(), np.asarray(want_c), **TOL)
        np.testing.assert_allclose(nh.numpy(), np.asarray(want_h), **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    tokens, c, h, embed, w, b = _inputs(16, 32, 32, 40, seed=1)
    x = torch.from_numpy(embed).to(torch.bfloat16)[torch.from_numpy(tokens).long()]
    args = (x, torch.from_numpy(c), torch.from_numpy(h),
            torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b))
    before = _ext.LAUNCHES["fused_lstm_step"]
    got = fused_lstm_step(*args)
    want = fused_lstm_step_plain(*args)
    assert _ext.LAUNCHES["fused_lstm_step"] == before  # no kernel launched
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_forget_bias_enters_the_forget_gate():
    """Zero weights: gates are the bias, so c' = sigmoid(b_f + fb)·c +
    sigmoid(b_i)·tanh(b_g) exactly."""
    N, E, H = 4, 32, 32
    c = torch.linspace(-1, 1, N * H).reshape(N, H)
    b = torch.zeros(4 * H)
    b[H:2 * H] = 0.5
    b[2 * H:3 * H] = 0.25
    new_c, new_h = fused_lstm_step(torch.zeros(N, E, dtype=torch.bfloat16), c,
                                   torch.zeros(N, H),
                                   torch.zeros(E + H, 4 * H,
                                               dtype=torch.bfloat16),
                                   b, forget_bias=1.0)
    want_c = (torch.sigmoid(torch.tensor(1.5)) * c
              + torch.sigmoid(torch.tensor(0.0)) * torch.tanh(torch.tensor(0.25)))
    torch.testing.assert_close(new_c, want_c)
    torch.testing.assert_close(new_h, torch.sigmoid(torch.tensor(0.0))
                               * torch.tanh(want_c))


def test_wrapper_rejects_tensors_on_mixed_devices():
    x = torch.zeros(2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused_lstm_step(x, torch.zeros(2, 32, device="meta"),
                        torch.zeros(2, 32), torch.zeros(64, 128,
                                                        dtype=torch.bfloat16),
                        torch.zeros(128))
