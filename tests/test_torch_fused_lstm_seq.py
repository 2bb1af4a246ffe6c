"""The port's fused teacher-forcing LSTM layer
(vae_captioning_torch/ops/fused_lstm_seq.py) against the JAX package's
``fused_lstm_seq`` run in interpret mode, forward and gradients, plus
the masked (``dynamic_rnn``) semantics and the lengths checks.

Both sides get the same numpy inputs.  The JAX kernels and the port's
plain versions compute the same bf16-operand, f32-accumulation maths in
another sum order.  Most f32 results then agree to ~1e-5, but now and
then an element of bf16(h) rounds the other way, which moves the next
step's gates by one bf16 step of h times a weight (~1e-3 here, weights
of std 0.3): so at least 99% of the elements of c_T and h_T must agree
to 1e-4 and all of them to 5e-3.  The gradients go through the bf16
dgates, which round the same way, hence a tolerance relative to each
gradient's largest element.

The backward's launch plan (``lstm_seq_plan``) is checked here too: the
dW splits and tiles at every shape the card checks use.  (No launch's
shared memory depends on the shape: the C sources fix it at compile
time and hold it to 227 KB with static_asserts.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import fused_lstm_seq as jfls
from vae_captioning_torch.ops import fused_lstm_seq as fls
from vae_captioning_torch.ops.fused_lstm_seq import (fused_lstm_seq,
                                                     fused_lstm_seq_plain,
                                                     lstm_seq_bwd_plain,
                                                     lstm_seq_fwd_plain,
                                                     lstm_seq_plan)

FWD_ATOL = 1e-4        # c_T, h_T: most elements ...
FWD_SHARE = 0.99       # ... this share of them ...
FWD_ATOL_ALL = 5e-3    # ... and every element; hs (bf16) to 2e-2
GRAD_RTOL = 2e-2       # of each gradient's max-abs


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfls.pl, "pallas_call", patched)
    yield jfls.fused_lstm_seq


def _inputs(T, B, E, H, seed=0, full=False):
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.normal(size=(T, B, E)).astype(np.float32),
        wx=rng.normal(0, 0.3, size=(E, 4 * H)).astype(np.float32),
        wh=rng.normal(0, 0.3, size=(H, 4 * H)).astype(np.float32),
        b=rng.normal(0, 0.1, size=(4 * H,)).astype(np.float32),
        c0=rng.normal(size=(B, H)).astype(np.float32),
        h0=rng.normal(size=(B, H)).astype(np.float32))
    if full:
        return arrs, np.full(B, T, np.int32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = 1, T
    return arrs, lengths


def _torch(arrs, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in arrs.items()}


def _jax_mask(lengths, T):
    return jnp.asarray(np.arange(T)[None, :] < lengths[:, None])


def _close_flips(got, want, what):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    share = float((diff <= FWD_ATOL).mean())
    assert share >= FWD_SHARE, f"{what}: {share:.4f} of elements within {FWD_ATOL}"
    assert diff.max() <= FWD_ATOL_ALL, f"{what}: max |diff| {diff.max():.3e}"


def _close(got, want, rtol_of_max, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    bound = rtol_of_max * max(np.abs(want).max(), 1e-6)
    assert err <= bound, f"{what}: max |diff| {err:.3e} > {bound:.3e}"


SHAPES = [(5, 128, 128, 128), (7, 300, 256, 128), (3, 64, 128, 256)]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(interpreted, shape):
    T, B, E, H = shape
    arrs, lengths = _inputs(*shape, seed=sum(shape))
    (ct, ht), hs = interpreted(*(jnp.asarray(arrs[k]) for k in
                                 ("x", "wx", "wh", "b", "c0", "h0")),
                               _jax_mask(lengths, T))
    t = _torch(arrs)
    (pct, pht), phs = fused_lstm_seq(t["x"], t["wx"], t["wh"], t["b"],
                                     t["c0"], t["h0"], torch.from_numpy(lengths))
    assert phs.dtype == torch.bfloat16 and phs.shape == (T, B, H)
    _close_flips(pct.numpy(), ct, f"c_T {shape}")
    _close_flips(pht.numpy(), ht, f"h_T {shape}")
    np.testing.assert_allclose(phs.float().numpy(),
                               np.asarray(hs, np.float32), rtol=0, atol=2e-2)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax(interpreted, shape):
    T, B, E, H = shape
    arrs, lengths = _inputs(*shape, seed=sum(shape) + 1)
    rng = np.random.default_rng(7)
    w_hs = rng.normal(size=(T, B, H)).astype(np.float32)
    w_c = rng.normal(size=(B, H)).astype(np.float32)
    w_h = rng.normal(size=(B, H)).astype(np.float32)
    names = ("x", "wx", "wh", "b", "c0", "h0")
    mask = _jax_mask(lengths, T)

    def loss(x, wx, wh, b, c0, h0):
        (ct, ht), hs = interpreted(x, wx, wh, b, c0, h0, mask)
        return (jnp.sum(hs.astype(jnp.float32) * w_hs) + jnp.sum(ct * w_c)
                + jnp.sum(ht * w_h))

    jgrads = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(arrs[k]) for k in names))
    t = _torch(arrs, grad=True)
    (ct, ht), hs = fused_lstm_seq(*(t[k] for k in names),
                                  torch.from_numpy(lengths))
    (hs.float() * torch.from_numpy(w_hs)).sum().add(
        (ct * torch.from_numpy(w_c)).sum()).add(
        (ht * torch.from_numpy(w_h)).sum()).backward()
    for name, jg in zip(names, jgrads):
        assert t[name].grad.dtype == torch.float32
        _close(t[name].grad.numpy(), jg, GRAD_RTOL, f"d{name} {shape}")


def test_masked_rows_pass_through():
    """A row of length 0 copies its carry through and emits zeros; a row
    stops stepping at its length and keeps that carry to the end."""
    T, B, E, H = 6, 4, 64, 64
    arrs, _ = _inputs(T, B, E, H, seed=3)
    lengths = np.array([0, 2, 6, 3], np.int32)
    t = _torch(arrs)
    args = (t["x"], t["wx"], t["wh"], t["b"], t["c0"], t["h0"])
    (ct, ht), hs = fused_lstm_seq(*args, torch.from_numpy(lengths))
    np.testing.assert_array_equal(ct[0].numpy(), arrs["c0"][0])
    np.testing.assert_array_equal(ht[0].numpy(), arrs["h0"][0])
    for row, n in enumerate(lengths):
        assert not hs[n:, row].float().abs().any()
        if n:
            assert hs[n - 1, row].float().abs().sum() > 0
    # row 1 (length 2) ends where a 2-step run of the same row ends
    (c2, h2), _ = fused_lstm_seq(
        t["x"][:2], t["wx"], t["wh"], t["b"], t["c0"], t["h0"],
        torch.full((B,), 2, dtype=torch.int32))
    torch.testing.assert_close(ct[1], c2[1], rtol=0, atol=0)
    torch.testing.assert_close(ht[1], h2[1], rtol=0, atol=0)


def test_plain_versions_match_autograd_of_the_step():
    """The hand-written backward against autograd through the plain
    forward's maths (f32, no bf16 rounding of the dgates), on full
    lengths where the two can only differ by that rounding."""
    T, B, E, H = 4, 16, 64, 64
    arrs, lengths = _inputs(T, B, E, H, seed=5, full=True)
    bf = torch.bfloat16
    t = {k: torch.tensor(v) for k, v in arrs.items()}
    args = (t["x"].to(bf), t["wx"].to(bf), t["wh"].to(bf), t["b"], t["c0"],
            t["h0"], torch.from_numpy(lengths))
    hs, cs, ga, h_t = lstm_seq_fwd_plain(*args)
    dhs = torch.randn(T, B, H, generator=torch.Generator().manual_seed(1))
    grads = lstm_seq_bwd_plain((*args, hs, cs, ga), dhs, torch.zeros(B, H),
                               torch.zeros(B, H))
    x = t["x"].to(bf).float().requires_grad_()
    wx = t["wx"].to(bf).float().requires_grad_()
    c, h = t["c0"], t["h0"]
    out = []
    for s in range(T):
        g = x[s] @ wx + h.to(bf).float() @ t["wh"].to(bf).float() + t["b"]
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    (torch.stack(out) * dhs.to(bf).float()).sum().backward()
    _close(grads[0].numpy(), x.grad.numpy(), 2e-2, "dx")
    _close(grads[1].numpy(), wx.grad.numpy(), 2e-2, "dWx")


def test_bad_lengths_raise():
    """Lengths, not a mask: any int32 length gives the monotone mask
    t < length; other types and shapes raise."""
    arrs, lengths = _inputs(3, 4, 64, 64)
    t = _torch(arrs)
    args = (t["x"], t["wx"], t["wh"], t["b"], t["c0"], t["h0"])
    with pytest.raises(ValueError, match="int32"):
        fused_lstm_seq(*args, torch.from_numpy(lengths).long())
    with pytest.raises(ValueError, match="int32"):
        fused_lstm_seq(*args, torch.from_numpy(lengths[:3]))
    with pytest.raises(ValueError, match="int32"):
        fused_lstm_seq(*args, torch.ones(4, 3, dtype=torch.bool))


def test_plain_entry_point_is_differentiable_and_equal():
    arrs, lengths = _inputs(4, 8, 64, 64, seed=9)
    t1, t2 = _torch(arrs, grad=True), _torch(arrs, grad=True)
    names = ("x", "wx", "wh", "b", "c0", "h0")
    lens = torch.from_numpy(lengths)
    (c1, h1), hs1 = fused_lstm_seq(*(t1[k] for k in names), lens)
    (c2, h2), hs2 = fused_lstm_seq_plain(*(t2[k] for k in names), lens)
    assert torch.equal(hs1, hs2) and torch.equal(c1, c2) and torch.equal(h1, h2)
    (hs1.float().sum() + c1.sum()).backward()
    (hs2.float().sum() + c2.sum()).backward()
    for k in names:
        assert torch.equal(t1[k].grad, t2[k].grad), k


# ----------------------------------------------------------------------
# the kernels' launch plan
# ----------------------------------------------------------------------

# (T, N, E, H) of chip_smoke.py's SEQ_SHAPES and the card tests: the train
# shapes, ragged rows, one row, one row past a tile, one step, E + H past
# a resident A, the narrowest widths
CARD_SHAPES = [(24, 1280, 256, 512), (7, 1000, 256, 512), (24, 1, 256, 512),
               (24, 65, 256, 512), (1, 1280, 256, 512), (5, 600, 256, 1024),
               (3, 70, 64, 64)]


def _dw_blocks(plan, E, H):
    """Output tiles of dWx and dWh: (E or H) / 64 x 4H / dw_ct."""
    return [(ko // 64) * (4 * H // plan.dw_ct) for ko in (E, H)]


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_plan_dw_splits_cover_every_row_once(shape):
    """Each dW product's splits are non-empty (the shared product loop
    needs a K tile in every block) and cover the T·N rows exactly once, in
    order; the partials' buffer holds every split of both products."""
    T, N, E, H = shape
    plan = lstm_seq_plan(*shape)
    assert (plan.k_tiles - 1) * 64 < T * N <= plan.k_tiles * 64
    counts = []
    for per in (plan.per_x, plan.per_h):
        splits = fls.dw_splits(plan.k_tiles, per)
        counts.append(len(splits))
        assert all(start < end for start, end in splits)
        rows = [r for start, end in splits for r in range(64 * start, min(64 * end, T * N))]
        assert rows == list(range(T * N))
    assert plan.w_part_rows == max(counts[0] * E, counts[1] * H)


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_plan_tiles_divide_the_outputs(shape):
    """dx [T·N, E] in 64 x 64·dx_wg tiles and dW [E or H, 4H] in 64 x
    dw_ct tiles, each dividing its output; a db partial per step and row
    tile."""
    T, N, E, H = shape
    plan = lstm_seq_plan(*shape)
    assert E % (64 * plan.dx_wg) == 0 and (4 * H) % plan.dw_ct == 0
    assert plan.db_parts == T * -(-N // 64)


def test_plan_at_the_train_shapes():
    """T = 24, N = 1280, E = 256, H = 512 on 132 SMs: dx with two
    warpgroups a block, dW in 512-column tiles with the 30,720 rows in 8
    splits (dWx) and 4 (dWh), 128 blocks each; the workspaces named in
    PERF.md."""
    plan = lstm_seq_plan(24, 1280, 256, 512)
    assert plan.dx_wg == 2 and plan.dw_ct == 512
    assert (plan.k_tiles, plan.per_x, plan.per_h) == (480, 60, 120)
    assert [b * -(-plan.k_tiles // per) for b, per in
            zip(_dw_blocks(plan, 256, 512), (plan.per_x, plan.per_h))] == [128, 128]
    assert plan.workspace_bytes(24, 1280, 256, 512) == {
        "hbuf": 25 * 1280 * 512 * 2, "hcarry": 2 * 1280 * 512 * 2,
        "dg": 24 * 1280 * 2048 * 2,
        "dcbuf": 1280 * 512 * 4, "db_part": 480 * 2048 * 4,
        "w_part": 2048 * 2048 * 4}


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_plan_dw_splits_fill_one_wave(sms):
    """A dW grid takes at most one block an SM where its output tiles
    allow it, and splits no more than that."""
    plan = lstm_seq_plan(24, 1280, 256, 512, sms)
    for per, blocks in zip((plan.per_x, plan.per_h), _dw_blocks(plan, 256, 512)):
        splits = -(-plan.k_tiles // per)
        assert per == -(-plan.k_tiles // max(1, sms // blocks))
        assert blocks * splits <= max(sms, blocks)
