"""The written-logits CE schedules of the port (ops/fused_ce.py: the
hybrid, ``Config.ce_hybrid``, and the XLA forward, ``Config.ce_xla_bwd``)
against the JAX package's: the plain twin and the wrapper's CPU branch of
each against the Pallas ``fused_linear_ce_hybrid`` and
``fused_linear_ce_xla_bwd`` in interpret mode (the loss, and the
gradients of h, w, b and the row weights through their custom VJPs); the
written logits against the Pallas forward's and ``_fwd_xla``'s residual;
zero-weight rows and labels outside the vocabulary; ``linear_ce`` over
time-major rows against ``kernel_shard.linear_ce``; the plain versions of
the three kernels; and the checks the kernel wrappers make.  The port's W
is the ``nn.Linear`` weight [V, H], the Flax kernel transposed."""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_fused_ce import _jax_side, _problem, _rel, _torch_side
from vae_captioning_tpu.ops import fused_ce as jfc
from vae_captioning_tpu.parallel import kernel_shard as jks
from vae_captioning_torch import _ext
from vae_captioning_torch.ops import fused_ce as tfc

SCHEDULES = {
    "hybrid": (jfc.fused_linear_ce_hybrid, tfc.fused_linear_ce_hybrid_plain,
               tfc.fused_linear_ce_hybrid),
    "xla_bwd": (jfc.fused_linear_ce_xla_bwd, tfc.fused_linear_ce_xla_bwd_plain,
                tfc.fused_linear_ce_xla_bwd),
}
# the loss and d weights (= lse - ll): the same f32 logits (hybrid) or the
# same bf16 logits (xla_bwd) reduced in another order, to FWD_REL (1.2e-7
# measured).  dh and dW: an element of the written logits whose f32 value
# the two sum orders put on either side of a bf16 rounding boundary (16-17
# of 600,000 in the hybrid, 1-5 in the XLA forward's bf16 product) moves
# its dl by one bf16 step, and an element of dl likewise; below GRAD_REL of
# the largest element (1.4e-5 measured).  db sums the f32 dl on both
# sides: FWD_REL (3.6e-6 measured)
FWD_REL = 1e-5
GRAD_REL = 1e-4
V_REAL = 2000           # the problem's vocabulary; JAX pads it to 2,560, the
VP = 2048               # port to 64-column tiles


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfc.pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_args(h, w, b, labels):
    return _t(h), _t(w.T), _t(b), _t(labels)


@pytest.mark.parametrize("which", [1, 2], ids=["plain", "wrapper"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_the_pallas_kernels(interpreted, schedule, which, seed):
    args = _problem(seed=seed)
    j_fn, fn = SCHEDULES[schedule][0], SCHEDULES[schedule][which]
    j_loss, jg = _jax_side(j_fn, *args)
    t_loss, tg = _torch_side(fn, *args)
    assert t_loss == pytest.approx(j_loss, rel=FWD_REL)
    for name, a, e, tol in zip(("dh", "dw", "db", "dweights"), tg, jg,
                               (GRAD_REL, GRAD_REL, FWD_REL, FWD_REL)):
        assert a.shape == e.shape and a.dtype == np.float32, name
        assert _rel(a, e) <= tol, (name, _rel(a, e))
    # rows of weight 0 get no gradient, exactly, on both sides
    zero = args[4] == 0
    assert np.all(tg[0][zero] == 0.0) and np.all(jg[0][zero] == 0.0)
    assert np.abs(tg[0][~zero]).max() > 0


# how far the f32 logits of two forwards may lie apart: two f32 sums of H
# = 64 products in another order (1.2e-7 measured, near 0 above the bf16
# step of the value itself)
S_ATOL = 1e-6


def _rounds_a_nearby_value(got, want, f32):
    """Where the bf16 values ``got`` (the port's, the rounding of its f32
    value ``f32``) and ``want`` differ, ``want`` is the rounding of an f32
    value within S_ATOL of ``f32``: another sum order crossed a bf16
    rounding boundary.  Returns how many differ."""
    diff = got != want
    half_step = np.spacing(np.abs(want[diff]).astype(np.float32)) * 2.0 ** 15
    assert np.all(np.abs(want[diff] - f32[diff]) <= half_step + S_ATOL)
    return int(diff.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_written_logits_match_the_pallas_forward(interpreted, seed):
    """``ce_mat_fwd_plain``'s lg against the lg that ``_fwd_mat`` keeps as
    its residual: bit for bit but where the f32 value lies on a bf16
    rounding boundary, pad columns -1e30 on both; lse and ll to FWD_REL."""
    args = _problem(seed=seed)
    _, (_, _, _, _, j_lg, j_lse, j_ll) = jfc._fwd_mat(
        *(jnp.asarray(a) for a in args))
    M = args[0].shape[0]
    j_lg = np.asarray(j_lg.astype(jnp.float32))[:M]
    h, w, b, labels = _port_args(*args[:4])
    lg, lse, ll = tfc.ce_mat_fwd_plain(h, w, b, labels)
    assert lg.dtype == torch.bfloat16 and lg.shape == (M, VP)
    assert tfc.logits_pitch(V_REAL) == VP
    f32 = tfc._logits(h, w, b).numpy()
    lg = lg.float().numpy()
    padded = np.pad(f32, ((0, 0), (0, VP - V_REAL)), constant_values=-1e30)
    np.testing.assert_array_equal(
        lg, torch.from_numpy(padded).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(lg[:, V_REAL:], j_lg[:, V_REAL:VP])
    assert np.all(lg[:, V_REAL:] < -1e29)
    n = _rounds_a_nearby_value(lg[:, :V_REAL], j_lg[:, :V_REAL], f32)
    assert n <= 1e-4 * f32.size
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:M, 0],
                               rtol=FWD_REL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll)[:M, 0],
                               rtol=FWD_REL, atol=FWD_REL)


@pytest.mark.parametrize("seed", [0, 1])
def test_xla_forward_matches_jax(seed):
    """``ce_xla_fwd_plain`` against ``_fwd_xla``: the bf16 product rounded,
    then the bf16 bias added and rounded again; lse from the bf16 logits.
    Its lg is bit for bit but where the two f32 products lie on either side
    of a bf16 rounding boundary."""
    args = _problem(seed=seed)
    _, (_, _, _, _, j_lg, j_lse, j_ll) = jfc._fwd_xla(
        *(jnp.asarray(a) for a in args))
    M = args[0].shape[0]
    j_lg = np.asarray(j_lg.astype(jnp.float32))[:M]
    lg, lse, ll = tfc.ce_xla_fwd_plain(*_port_args(*args[:4]))
    assert lg.dtype == torch.bfloat16 and lg.shape == (M, VP)
    lg = lg.float().numpy()
    np.testing.assert_array_equal(lg[:, V_REAL:], j_lg[:, V_REAL:VP])
    diff = lg[:, :V_REAL] != j_lg[:, :V_REAL]
    assert diff.sum() <= 1e-4 * diff.size
    step = np.abs(j_lg[:, :V_REAL][diff]) * 2.0 ** -7
    # a product one bf16 step apart, plus the bias add's own rounding
    assert np.all(np.abs(lg[:, :V_REAL] - j_lg[:, :V_REAL])[diff] <= 2.01 * step + 1e-30)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:M, 0],
                               rtol=FWD_REL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll)[:M, 0],
                               rtol=FWD_REL, atol=FWD_REL)


def test_the_xla_forward_rounds_the_product_before_the_bias():
    """The separate bf16 bias add differs from the f32 bias of the hybrid
    (one rounding): on a bias far above the product's bf16 step they
    disagree, and lg equals bf16(bf16(h W^T) + bf16(b))."""
    h, w, b, labels, _ = _problem(M=64, V=300, seed=7)
    h, w, b, labels = _port_args(h, w, b, labels)
    b = b * 100.0
    lg, _, _ = tfc.ce_xla_fwd_plain(h, w, b, labels)
    bf16 = torch.bfloat16
    want = (h.to(bf16) @ w.to(bf16).t()) + b.to(bf16)
    torch.testing.assert_close(lg[:, :300], want, rtol=0, atol=0)
    one_rounding = (tfc._logits(h, w, b)).to(bf16)
    assert not torch.equal(lg[:, :300], one_rounding)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_rows_of_weight_zero_may_carry_any_label(schedule):
    """Labels outside the vocabulary, in its pad columns included (100..127
    of the written logits' 128), on rows of weight 0 pick nothing and add
    nothing: the loss and every gradient equal those of label 0."""
    fn = SCHEDULES[schedule][1]
    h, w, b, labels, weights = _problem(M=40, V=100, seed=3)
    outs = []
    for bad in (0, -1, 100, 127, 12345):
        lab = labels.copy()
        lab[weights == 0] = bad
        outs.append(_torch_side(fn, h, w, b, lab, weights))
    for loss, grads in outs[1:]:
        assert loss == outs[0][0]
        for a, e in zip(grads[:3], outs[0][1][:3]):
            np.testing.assert_array_equal(a, e)


@pytest.mark.parametrize("which", [1, 2], ids=["plain", "wrapper"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_linear_ce_matches_kernel_shard(interpreted, schedule, which):
    """Time-major hidden rows [T, N, H] and labels [T, N] with PAD (0)
    rows, flattened and weighted as the JAX package's single-device
    ``linear_ce`` does, through each schedule."""
    j_fn, fn = SCHEDULES[schedule][0], SCHEDULES[schedule][which]
    rng = np.random.default_rng(5)
    T, N, H, V = 6, 9, 64, 300
    hidden = rng.normal(size=(T, N, H)).astype(np.float32)
    w = rng.normal(0, 0.1, size=(H, V)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(V,)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=N)
    labels = rng.integers(1, V, size=(T, N)).astype(np.int32)
    labels[np.arange(T)[:, None] >= lengths[None, :]] = 0
    j_loss, (j_dh, j_dw, j_db) = jax.value_and_grad(
        lambda hd, ww, bb: jks.linear_ce(j_fn, hd, ww, bb, jnp.asarray(labels),
                                         batch_axis=1),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (hidden, w, b)))
    t_hidden = _t(hidden).requires_grad_()
    t_w = _t(w.T).requires_grad_()
    t_b = _t(b).requires_grad_()
    t_loss = tfc.linear_ce(t_hidden, t_w, t_b, _t(labels), ce_fn=fn)
    t_loss.backward()
    assert float(t_loss.detach()) == pytest.approx(float(j_loss), rel=FWD_REL)
    assert _rel(t_hidden.grad.numpy(), j_dh) <= GRAD_REL
    assert _rel(t_w.grad.numpy(), np.asarray(j_dw).T) <= GRAD_REL
    assert _rel(t_b.grad.numpy(), j_db) <= FWD_REL
    assert np.all(t_hidden.grad.numpy()[labels == 0] == 0.0)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_plain_backward_is_the_kernels_function(schedule):
    """``ce_mat_dh_plain`` and ``ce_mat_dwdb_plain``, the yardsticks of
    the two backward kernels, over the schedule's own written logits give
    the plain twin's gradients exactly."""
    fwd = tfc.ce_mat_fwd_plain if schedule == "hybrid" else tfc.ce_xla_fwd_plain
    h, w, b, labels, weights = _problem(M=50, V=300, seed=4)
    h, w, b, labels = _port_args(h, w, b, labels)
    weights = _t(weights)
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    SCHEDULES[schedule][1](*leaves, labels, weights).backward()
    lg, lse, _ = fwd(h, w, b, labels)
    dh = tfc.ce_mat_dh_plain(lg, w, labels, lse, weights)
    dw, db = tfc.ce_mat_dwdb_plain(h, lg, labels, lse, weights, 300)
    for got, leaf in zip((dh, dw, db), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=0)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_weights_need_no_gradient(schedule):
    h, w, b, labels, weights = _problem(M=20, V=50, seed=6)
    t_h = _t(h).requires_grad_()
    loss = SCHEDULES[schedule][2](t_h, _t(w.T), _t(b), _t(labels), _t(weights))
    loss.backward()
    assert t_h.grad.shape == (20, 64) and bool(torch.isfinite(t_h.grad).all())


@pytest.mark.parametrize("lg_shape,labels,op,V,match", [
    ((8, 64), (8,), (50, 96), 50, "one of"),
    ((8, 64), (8,), (50,), 50, "one of"),
    ((8, 50), (8,), (50, 64), 50, "not bf16"),
    ((7, 64), (8,), (50, 64), 50, "not bf16"),
    ((8, 128), (8,), (65, 64), 65, None),
    ((8, 64), (8,), (65, 64), 65, "not bf16"),
    ((0, 64), (0,), (50, 64), 50, "no rows"),
    ((8, 64, 1), (8,), (50, 64), 50, "lg \\[M, Vp\\]"),
])
def test_kernel_shape_rules(lg_shape, labels, op, V, match):
    """The checks the backward kernels' operands meet before a launch: lg
    bf16 [M, 64 ceil(V / 64)], labels int32, the bf16 operand [., H] with
    H a width the kernels are built for."""
    lg = torch.zeros(lg_shape, dtype=torch.bfloat16)
    lab = torch.zeros(labels, dtype=torch.int32)
    op = torch.zeros(op, dtype=torch.bfloat16)
    if match is None:
        assert tfc._check_mat(lg, lab, op, V) == labels[0]
        for bad in ((lg, lab.long(), op), (lg, lab, op.float()),
                    (lg, lab, op.t().contiguous().t())):
            with pytest.raises(ValueError, match="int32 and the bf16"):
                tfc._check_mat(*bad, V)
        return
    with pytest.raises(ValueError, match=match):
        tfc._check_mat(lg, lab, op, V)


# ----------------------------------------------------------------------
# the dW/db wrapper's launch on the CPU, the C entry point stood in by the
# plain version (the routing a card takes, as tests/test_torch_padding.py
# takes it for the other wrappers)
# ----------------------------------------------------------------------

def _over(ptr, shape, dtype):
    """A CPU tensor over the memory at ``ptr``: what the stand-in entry
    point reads and writes of the wrapper's operands."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * n).from_address(ptr), dtype=dtype).view(shape)


class _StandIn:
    """``vct_fused_ce_mat_dwdb`` in plain PyTorch, on the C side's rules:
    it reads h, lg and the row operands and gets [splits, Vp, H] and
    [splits, Vp] partials; with dw and db null (one split only) dW and db
    land in the partials' first V rows, else the partials are filled with
    NaN (what the kernel writes there is summed into dw and db, never
    returned) and dW and db land in dw and db.  Returns ``err`` (a
    cudaError_t)."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def vct_fused_ce_mat_dwdb(self, h, lg, lab, lse, gw, dw_part, db_part, dw, db,
                              M, H, V, splits, per, stream):
        Vp = -(-V // 64) * 64
        want_dw, want_db = tfc.ce_mat_dwdb_plain(
            _over(h, (M, H), torch.bfloat16), _over(lg, (M, tfc.logits_pitch(V)), torch.bfloat16),
            _over(lab, (M,), torch.int32), _over(lse, (M,), torch.float32),
            _over(gw, (M,), torch.float32), V)
        self.calls.append(dict(H=H, V=V, splits=splits, per=per, in_place=dw is None))
        parts = (_over(dw_part, (splits, Vp, H), torch.float32),
                 _over(db_part, (splits, Vp), torch.float32))
        if dw is None:
            assert db is None and splits == 1
            parts[0][0, :V], parts[1][0, :V] = want_dw, want_db
        else:
            parts[0].fill_(float("nan"))
            parts[1].fill_(float("nan"))
            _over(dw, (V, H), torch.float32).copy_(want_dw)
            _over(db, (V,), torch.float32).copy_(want_db)
        return self.err


@pytest.fixture()
def stand_in(monkeypatch):
    """The dW/db wrapper on CPU tensors as on a card of 132 SMs, its C
    entry point the plain version (_StandIn)."""
    lib = _StandIn()
    monkeypatch.setattr(_ext, "library", lambda: lib)
    monkeypatch.setattr(_ext, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tfc, "_sms", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return lib


def _dwdb_operands(M, H, V, seed):
    h, w, b, labels, weights = _problem(M=M, H=H, V=V, seed=seed)
    h, w, b, labels = _port_args(h, w, b, labels)
    lg, lse, _ = tfc.ce_mat_fwd_plain(h, w, b, labels)
    return (h.to(torch.bfloat16), lg, labels.to(torch.int32), lse, _t(weights))


@pytest.mark.parametrize("M,H,V,splits", [
    (50, 1024, 301, 1), (60, 1024, 37, 1), (200, 1024, 301, 4),
    (200, 512, 301, 4), (50, 576, 2000, 1), (50, 256, 301, 1)])
def test_dwdb_wrapper_launches_on_the_plan(stand_in, M, H, V, splits):
    """The wrapper's branch on a card: it hands the entry point the row
    splits of ce_bwd_plan; at one split it asks for dW and db in place and
    returns the first V rows of the one partial, else it passes dw and db
    and returns them, never the partials; either is [V, H] and [V],
    contiguous, the plain version's, and counts one launch."""
    ops = _dwdb_operands(M, H, V, seed=M + V)
    plan = tfc.ce_bwd_plan(M, H, V, 132)
    assert plan.splits == splits
    before = _ext.LAUNCHES[tfc.DWDB_MAT]
    dw, db = tfc.ce_mat_dwdb_kernel(*ops, V)
    call, = stand_in.calls
    assert call == dict(H=H, V=V, splits=splits, per=plan.dwdb_per, in_place=splits == 1)
    assert _ext.LAUNCHES[tfc.DWDB_MAT] == before + 1
    assert dw.shape == (V, H) and db.shape == (V,) and dw.is_contiguous()
    want = tfc.ce_mat_dwdb_plain(*ops, V)
    assert torch.equal(dw, want[0]) and torch.equal(db, want[1])


def test_dwdb_wrapper_raises_on_a_failed_launch(stand_in):
    """A launch that returns a cudaError_t raises, naming the written
    logits' dW/db, and counts no launch; nothing stands in for the
    kernel."""
    stand_in.err = 2
    before = _ext.LAUNCHES[tfc.DWDB_MAT]
    with pytest.raises(RuntimeError, match="fused_linear_ce_mat_dwdb: .*cudaError_t 2"):
        tfc.ce_mat_dwdb_kernel(*_dwdb_operands(50, 1024, 301, seed=1), 301)
    assert _ext.LAUNCHES[tfc.DWDB_MAT] == before


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("M", [50, 130])
@pytest.mark.parametrize("H", [1000, 1024])
def test_wide_dwdb_matches_the_pallas_kernel(interpreted, stand_in, monkeypatch,
                                             schedule, M, H):
    """dW and db of each written-logits schedule at the wide cell's width
    (1000 padded to 1024) and an odd vocab-tile count (V = 301, five
    tiles), through the wrappers' card branch (the forward and dh plain,
    the dW/db wrapper's launch stood in by the plain version; one split at
    M = 50, in place, three at 130) against the Pallas kernels in interpret
    mode."""
    monkeypatch.setattr(_ext, "on_cpu", lambda *t: False)
    fns = tfc.MatFns(tfc.ce_mat_fwd_plain if schedule == "hybrid" else tfc.ce_xla_fwd_plain,
                     tfc.ce_mat_dh_plain, tfc.ce_mat_dwdb_kernel)
    monkeypatch.setattr(tfc, "HYBRID_KERNELS" if schedule == "hybrid" else "XLA_BWD_KERNELS", fns)
    args = _problem(M=M, H=H, V=301, seed=M + H)
    j_loss, jg = _jax_side(SCHEDULES[schedule][0], *args)
    t_loss, tg = _torch_side(SCHEDULES[schedule][2], *args)
    call, = stand_in.calls
    assert call["H"] == 1024 and call["splits"] == (1 if M == 50 else 3)
    assert call["in_place"] == (M == 50)
    assert t_loss == pytest.approx(j_loss, rel=FWD_REL)
    for name, a, e, tol in zip(("dw", "db"), tg[1:3], jg[1:3], (GRAD_REL, FWD_REL)):
        assert a.shape == e.shape and a.dtype == np.float32, name
        assert _rel(a, e) <= tol, (name, _rel(a, e))
