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
                                                      fused_lstm_step_plain,
                                                      lstm_step_plan)
from vae_captioning_torch.ops.fused_lstm_step import (
    lstm_step_geometry as fused_lstm_step_geometry)

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


# (N, E, H): the decode rows at the train widths (greedy, beam 3, beam 10),
# one row, one row past a tile, the card tests' narrow widths and one whose
# A is taken in chunks
PLAN_DIMS = [(512, 256, 512), (1536, 256, 512), (5120, 256, 512),
             (1, 256, 512), (65, 256, 512), (1, 32, 32), (200, 64, 96),
             (65, 32, 96), (70, 256, 1536)]


@pytest.mark.parametrize("units", [64, 32])
@pytest.mark.parametrize("N,E,H", PLAN_DIMS)
def test_step_geometry_covers_each_element_once(N, E, H, units):
    """Under the kernel's rules: block (x, y) takes rows [64x, 64x + 64)
    and its warpgroup w the units [2U·y + U·w, 2U·y + U·w + U), so every
    (row, unit) of c' and h' is computed once; and the K boxes meet every
    row of W once (x box c: W rows 64c + i for i < 64 with 64c + i < E, h
    box t: rows E + 64t + i with 64t + i < H; the other A columns are
    zero)."""
    plan = fused_lstm_step_geometry(N, E, H, units)
    assert plan.units == units
    rows = np.zeros(N, np.int64)
    for x in range(plan.grid[0]):
        rows[64 * x:64 * x + 64] += 1
    assert np.all(rows == 1)
    unit = np.zeros(H, np.int64)
    for y in range(plan.grid[1]):
        for w in range(2):
            lo = 2 * units * y + units * w
            unit[lo:lo + units] += 1
    assert np.all(unit == 1)
    nx, nh = -(-E // 64), -(-H // 64)
    w_rows = np.zeros(E + H, np.int64)
    for c in range(nx):
        w_rows[64 * c:min(E, 64 * c + 64)] += 1
    for t in range(nh):
        w_rows[E + 64 * t:E + min(H, 64 * t + 64)] += 1
    assert np.all(w_rows == 1)


@pytest.mark.parametrize("N,E,H", PLAN_DIMS)
def test_step_plan_fills_the_sms(N, E, H):
    """The plan is the geometry at U = 32 where U = 64 would give fewer
    blocks than half the 132 SMs, else at U = 64: at E = 256, H = 512, U =
    32 at N = 512 and U = 64 at N = 1536 and 5120.  (The shared memory
    of each width is the kernel's own; the card tests check it.)"""
    plan = lstm_step_plan(N, E, H)
    wide = fused_lstm_step_geometry(N, E, H, 64)
    narrow = 2 * wide.grid[0] * wide.grid[1] < 132
    assert plan == fused_lstm_step_geometry(N, E, H, 32 if narrow else 64)
    if (E, H) == (256, 512) and N in (512, 1536, 5120):
        assert plan.units == {512: 32, 1536: 64, 5120: 64}[N]
