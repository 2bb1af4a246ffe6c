"""The kernels' width padding (vae_captioning_torch/ops/padding.py and
each wrapper's ``pad_*``): at widths the CUDA kernels do not take (E =
40 and 300, H = 48 and 500: none a multiple of 32 or a CE kernel width)
each padding function feeds the plain version padded operands, and the
sliced result, and every gradient autograd returns through the padding,
must equal the plain version's on the unpadded operands.  Padding adds
only 0·x terms, so the tolerance is f32 sum order alone: 1e-6 of the
largest element (bit for bit where no product is involved).

Then the routing: with ``_ext.on_cpu`` patched to say "CUDA" and each
kernel launch replaced by a stand-in that checks it was handed widths
its kernel takes and computes the plain version, every wrapper at those
widths pads, launches once and returns the unpadded plain result (the
path a card takes, here on the CPU).  The plain versions themselves are
held against the JAX kernels in the other test_torch_* files."""

import pytest
import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.ops import fused_ag_heads as tfah
from vae_captioning_torch.ops import fused_ce as tfc
from vae_captioning_torch.ops import fused_logits_topk as tflt
from vae_captioning_torch.ops import fused_lstm_seq as tfls
from vae_captioning_torch.ops import fused_lstm_step as tfst
from vae_captioning_torch.ops import fused_z as tfz
from vae_captioning_torch.ops import padding

WIDTHS = [(40, 48), (300, 500)]      # (E, H)
REL = 1e-6


def _close(got, want, rel=REL):
    got, want = got.detach().double(), want.detach().double()
    scale = want.abs().max().clamp_min(1e-30)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / scale) <= rel


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------------------
# the helpers
# ----------------------------------------------------------------------

def test_round_up_and_next_width():
    assert [padding.round_up(n, 32) for n in (1, 32, 33, 500)] == [32, 32, 64, 512]
    assert [padding.next_width(n, tfc.KERNEL_H) for n in (1, 64, 65, 500, 512)] \
        == [64, 64, 128, 512, 512]
    with pytest.raises(ValueError, match="exceeds"):
        padding.next_width(513, tfc.KERNEL_H)
    # the CE's widths: the next of KERNEL_H up to 512, past it the next
    # multiple of 64 up to CE_H_MAX
    assert [tfc.ce_width(n) for n in (1, 64, 65, 500, 512, 513, 520, 576, 1000,
                                      1024, 2000, 4096)] \
        == [64, 64, 128, 512, 512, 576, 576, 576, 1024, 1024, 2048, 4096]
    with pytest.raises(ValueError, match="up to 4096"):
        tfc.ce_width(4097)


@pytest.mark.parametrize("E,H", WIDTHS)
def test_lstm_kernel_padding_keeps_every_gate_block(E, H):
    """Each of the x rows, the h rows and the four gate blocks lands where
    the padded kernel reads it; every other element is 0."""
    w = torch.randn((E + H, 4 * H), generator=_gen(0))
    Ep, Hp = padding.round_up(E, 64), padding.round_up(H, 64)
    wp = padding.pad_lstm_kernel(w, E, H, Ep, Hp)
    assert wp.shape == (Ep + Hp, 4 * Hp)
    for g in range(4):
        assert torch.equal(wp[:E, g * Hp:g * Hp + H], w[:E, g * H:(g + 1) * H])
        assert torch.equal(wp[Ep:Ep + H, g * Hp:g * Hp + H],
                           w[E:, g * H:(g + 1) * H])
    assert float(wp.abs().sum()) == pytest.approx(float(w.abs().sum()), rel=1e-6)
    b = torch.randn(4 * H, generator=_gen(1))
    bp = padding.pad_gates(b, H, Hp).reshape(4, Hp)
    assert torch.equal(bp[:, :H], b.reshape(4, H)) and not bp[:, H:].any()


# ----------------------------------------------------------------------
# each padding function against the unpadded plain version
# ----------------------------------------------------------------------

def _lstm_step_args(N, E, H, seed=0):
    g = _gen(seed)
    return (torch.randn((N, E), generator=g).to(torch.bfloat16),
            torch.randn((N, H), generator=g),
            torch.tanh(torch.randn((N, H), generator=g)),
            (torch.randn((E + H, 4 * H), generator=g) * 0.1).to(torch.bfloat16),
            torch.randn(4 * H, generator=g) * 0.1)


@pytest.mark.parametrize("E,H", WIDTHS)
def test_lstm_step_padding_is_exact(E, H):
    args = _lstm_step_args(33, E, H)
    want_c, want_h = tfst.fused_lstm_step_plain(*args)
    padded = tfst.pad_lstm_step(*args)
    assert padded[0].shape[1] % 32 == 0 and padded[1].shape[1] % 32 == 0
    got_c, got_h = tfst.fused_lstm_step_plain(*padded)
    # the padded units stay exactly 0
    assert not got_c[:, H:].any() and not got_h[:, H:].any()
    _close(got_c[:, :H], want_c)
    _close(got_h[:, :H], want_h)


def _seq_args(T, N, E, H, seed=0):
    g = _gen(seed)
    lengths = torch.randint(1, T + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0] = T
    return (torch.randn((T, N, E), generator=g),
            torch.randn((E, 4 * H), generator=g) * 0.1,
            torch.randn((H, 4 * H), generator=g) * 0.1,
            torch.randn(4 * H, generator=g) * 0.1,
            torch.randn((N, H), generator=g) * 0.5,
            torch.randn((N, H), generator=g) * 0.5, lengths)


def _seq_loss(out, g):
    (c, h), hs = out
    return (hs.float() * g[0]).sum() + (c * g[1]).sum() + (h * g[2]).sum()


@pytest.mark.parametrize("E,H", WIDTHS[:1] + [(64, 48), (40, 64)])
def test_lstm_seq_padding_is_exact_forward_and_backward(E, H):
    T, N = 5, 9
    args = _seq_args(T, N, E, H)
    g = _gen(7)
    cots = (torch.randn((T, N, H), generator=g), torch.randn((N, H), generator=g),
            torch.randn((N, H), generator=g))
    leaves = [a.clone().requires_grad_() for a in args[:6]]
    want = tfls.fused_lstm_seq_plain(*leaves, args[6])
    _seq_loss(want, cots).backward()
    want_grads = [leaf.grad for leaf in leaves]
    leaves = [a.clone().requires_grad_() for a in args[:6]]
    padded = tfls.pad_lstm_seq(*leaves)
    assert padded[0].shape[-1] % 64 == 0 and padded[4].shape[1] % 64 == 0
    (c, h), hs = tfls.fused_lstm_seq_plain(*padded, args[6])
    got = ((c[:, :H], h[:, :H]), hs[..., :H])
    _close(got[1].float(), want[1].float(), rel=0)      # bf16 outputs
    _close(got[0][0], want[0][0])
    _close(got[0][1], want[0][1])
    _seq_loss(got, cots).backward()
    for leaf, w in zip(leaves, want_grads):
        _close(leaf.grad, w, rel=1e-5)


def _z_args(N=17, K=3, L=5, E=40, seed=0):
    g = _gen(seed)
    return (torch.randn((N, L), generator=g), torch.rand((N, L), generator=g) + 0.1,
            torch.randn((E, K * L), generator=g) * 0.2,
            torch.randn(E, generator=g) * 0.1, K,
            torch.randn((N, K, L), generator=g))


@pytest.mark.parametrize("E", [40, 300])
def test_fused_z_padding_is_exact_forward_and_backward(E):
    mean, std, w, b, K, eps = _z_args(E=E)
    cot = torch.randn((mean.shape[0], E), generator=_gen(3))
    leaves = [t.clone().requires_grad_() for t in (mean, std, w, b)]
    want = tfz.fused_z_plain(*leaves, K, eps=eps)
    (want.float() * cot).sum().backward()
    want_grads = [leaf.grad for leaf in leaves]
    leaves = [t.clone().requires_grad_() for t in (mean, std, w, b)]
    wp, bp = tfz.pad_z(leaves[2], leaves[3])
    assert wp.shape[0] % 64 == 0
    got = tfz.fused_z_plain(leaves[0], leaves[1], wp, bp, K, eps=eps)[:, :E]
    _close(got.float(), want.float(), rel=0)
    (got.float() * cot).sum().backward()
    for leaf, w_ in zip(leaves, want_grads):
        _close(leaf.grad, w_)


def _ag_args(N=11, H=48, K=5, L=7, seed=0):
    g = _gen(seed)
    cv = torch.rand((N, K), generator=g)
    return (torch.randn((N, H), generator=g),
            torch.randn((2 * K * L, H), generator=g) * 0.1,
            torch.randn(2 * K * L, generator=g) * 0.1, cv / cv.sum(1, keepdim=True))


@pytest.mark.parametrize("H", [48, 500])
def test_ag_heads_padding_is_exact_forward_and_backward(H):
    args = _ag_args(H=H)
    g = _gen(4)
    cots = (torch.randn((11, 7), generator=g), torch.randn((11, 7), generator=g))
    leaves = [a.clone().requires_grad_() for a in args]
    want = tfah.ag_heads_plain(*leaves)
    sum((o * c).sum() for o, c in zip(want, cots)).backward()
    want_grads = [leaf.grad for leaf in leaves]
    leaves = [a.clone().requires_grad_() for a in args]
    hp, wp = tfah.pad_ag_heads(leaves[0], leaves[1])
    assert hp.shape[1] % tfah.K_STEP == 0
    got = tfah.ag_heads_plain(hp, wp, leaves[2], leaves[3])
    for o, w_ in zip(got, want):
        _close(o, w_)
    sum((o * c).sum() for o, c in zip(got, cots)).backward()
    for leaf, w_ in zip(leaves, want_grads):
        _close(leaf.grad, w_)


def _ce_args(M=37, H=48, V=70, seed=0):
    g = _gen(seed)
    labels = torch.randint(0, V, (M,), generator=g)
    weights = (torch.rand(M, generator=g) > 0.2).float()
    return (torch.randn((M, H), generator=g), torch.randn((V, H), generator=g) * 0.1,
            torch.randn(V, generator=g), labels, weights / weights.sum())


CE_PLAIN = [tfc.fused_linear_ce_plain, tfc.fused_linear_ce_hybrid_plain,
            tfc.fused_linear_ce_xla_bwd_plain]


@pytest.mark.parametrize("fn", CE_PLAIN, ids=["flash", "hybrid", "xla_bwd"])
@pytest.mark.parametrize("H", [48, 500])
def test_ce_padding_is_exact_forward_and_backward(fn, H):
    h, w, b, labels, weights = _ce_args(H=H)
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    want = fn(*leaves, labels, weights)
    want.backward()
    want_grads = [leaf.grad for leaf in leaves]
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    hp, wp = tfc.pad_ce(leaves[0], leaves[1])
    assert hp.shape[1] in tfc.KERNEL_H
    got = fn(hp, wp, leaves[2], labels, weights)
    _close(got, want)
    got.backward()
    for leaf, w_ in zip(leaves, want_grads):
        _close(leaf.grad, w_, rel=1e-5)


def _logits_args(M=19, H=48, V=300, seed=0):
    g = _gen(seed)
    return (torch.tanh(torch.randn((M, H), generator=g)).to(torch.bfloat16),
            (torch.randn((H, V), generator=g) * 0.3).to(torch.bfloat16),
            torch.randn(V, generator=g))


@pytest.mark.parametrize("H", [48, 500])
def test_logits_padding_is_exact(H):
    h, w, b = _logits_args(H=H)
    hp, wtp = tflt.pad_logits(h, w.t().contiguous())
    assert hp.shape[1] % 32 == 0 and wtp.shape == (w.shape[1], hp.shape[1])
    want = tflt.fused_logits_top_k_plain(h, w, b, 5)
    got = tflt.fused_logits_top_k_plain(hp, wtp.t(), b, 5)
    _close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    _close(got[2], want[2])
    for step in (0, 3):
        assert torch.equal(
            tflt.fused_logits_sample_plain(hp, wtp.t(), b, 11, step, 0.8),
            tflt.fused_logits_sample_plain(h, w, b, 11, step, 0.8))
    # int8: zeros leave the per-row scale, and the integer product, as is
    wq, ws = tflt.quantize_logits_weights(w.float())
    hq, hs = tflt.quantize_rows(h.float())
    hqp, wqtp = tflt.pad_logits(hq, wq.t(), tflt.INT8_WIDTH_STEP)
    assert hqp.shape[1] % 64 == 0
    assert torch.equal(tflt.quantize_rows(torch.nn.functional.pad(
        h.float(), (0, hqp.shape[1] - H)))[1], hs)
    got8 = tflt.int8_top_k_plain(hqp, hs, wqtp.t(), ws, b, 5)
    want8 = tflt.int8_top_k_plain(hq, hs, wq, ws, b, 5)
    for a, e in zip(got8, want8):
        assert torch.equal(a, e)


# ----------------------------------------------------------------------
# the routing: each wrapper on "CUDA" pads, launches once, slices back
# ----------------------------------------------------------------------

@pytest.fixture()
def on_card(monkeypatch):
    """The wrappers take their kernel branch on CPU tensors; the kernel
    launches are patched by each test.  Returns the launches by name."""
    monkeypatch.setattr(_ext, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_ext, "sm_count", lambda index=None: 132)
    return []


def test_lstm_step_wrapper_pads_and_slices(on_card, monkeypatch):
    def kernel(x, c, h, w, b, forget_bias, plan):
        assert x.shape[1] % 32 == 0 and c.shape[1] % 32 == 0
        on_card.append("step")
        return tfst.fused_lstm_step_plain(x, c, h, w, b, forget_bias)

    monkeypatch.setattr(tfst, "lstm_step_kernel", kernel)
    args = _lstm_step_args(21, 40, 48, seed=5)
    got = tfst.fused_lstm_step(*args)
    want = tfst.fused_lstm_step_plain(*args)
    assert on_card == ["step"]
    for g, w in zip(got, want):
        _close(g, w)


def test_lstm_seq_wrapper_pads_and_slices(on_card, monkeypatch):
    def fwd(x16, wx16, wh16, b, c0, h0, lengths):
        assert x16.shape[-1] % 64 == 0 and c0.shape[1] % 64 == 0
        on_card.append("fwd")
        hs, cs, ga, h_t = tfls.lstm_seq_fwd_plain(x16, wx16, wh16, b, c0, h0,
                                                  lengths)
        return torch.cat([h0.to(torch.bfloat16)[None], hs]), cs, ga, h_t

    def bwd(saved, dhs, dct, dht, h_prev=None):
        assert saved[0].shape[-1] % 64 == 0
        on_card.append("bwd")
        return tfls.lstm_seq_bwd_plain(saved, dhs, dct, dht)

    monkeypatch.setattr(tfls, "_fwd_launch", fwd)
    monkeypatch.setattr(tfls, "_check_shapes", lambda *a: None)
    monkeypatch.setattr(tfls, "lstm_seq_bwd_kernel", bwd)
    T, N, E, H = 4, 6, 40, 48
    args = _seq_args(T, N, E, H, seed=2)
    g = _gen(8)
    cots = (torch.randn((T, N, H), generator=g), torch.randn((N, H), generator=g),
            torch.randn((N, H), generator=g))
    leaves = [a.clone().requires_grad_() for a in args[:6]]
    got = tfls.fused_lstm_seq(*leaves, args[6])
    _seq_loss(got, cots).backward()
    assert on_card == ["fwd", "bwd"]
    got_grads = [leaf.grad for leaf in leaves]
    leaves = [a.clone().requires_grad_() for a in args[:6]]
    want = tfls.fused_lstm_seq_plain(*leaves, args[6])
    _seq_loss(want, cots).backward()
    assert got[1].shape == (T, N, H) and got[0][0].shape == (N, H)
    _close(got[1].float(), want[1].float(), rel=0)
    for g_, leaf in zip(got_grads, leaves):
        _close(g_, leaf.grad, rel=1e-5)


def test_fused_z_wrapper_pads_and_slices(on_card, monkeypatch):
    mean, std, w, b, K, _ = _z_args(E=40)
    eps = tfz.philox_normals(3, 4, mean.shape[0], K, mean.shape[1])

    def fwd(mean, std, w16, b, n, seed, step):
        assert w16.shape[0] % 64 == 0
        on_card.append("fwd")
        return tfz.z_fwd_plain(mean, std, w16, b, n, eps)

    def bwd(mean, std, w16, n, seed, step, g):
        on_card.append("bwd")
        return tfz.z_bwd_plain(mean, std, w16, n, eps, g)

    monkeypatch.setattr(tfz, "z_fwd_kernel", fwd)
    monkeypatch.setattr(tfz, "z_bwd_kernel", bwd)
    leaves = [t.clone().requires_grad_() for t in (mean, std, w, b)]
    got = tfz.fused_z(*leaves, K, 3, 4)
    got.float().sum().backward()
    assert on_card == ["fwd", "bwd"] and got.shape == (mean.shape[0], 40)
    got_grads = [leaf.grad for leaf in leaves]
    leaves = [t.clone().requires_grad_() for t in (mean, std, w, b)]
    want = tfz.fused_z_plain(*leaves, K, 3, 4)
    want.float().sum().backward()
    _close(got.float(), want.float(), rel=0)
    for g_, leaf in zip(got_grads, leaves):
        _close(g_, leaf.grad)


def test_ag_heads_wrapper_pads_and_slices(on_card, monkeypatch):
    def fwd(h16, w16, b, cv):
        assert h16.shape[1] % tfah.K_STEP == 0
        on_card.append("fwd")
        return tfah.ag_heads_plain(h16, w16, b, cv)

    def bwd(h16, w16, b, cv, gm, gs):
        on_card.append("bwd")
        return tfah.ag_heads_bwd_plain(h16, w16, b, cv, gm, gs)

    monkeypatch.setattr(tfah, "ag_heads_fwd_kernel", fwd)
    monkeypatch.setattr(tfah, "ag_heads_bwd_kernel", bwd)
    args = _ag_args(H=48, seed=3)
    leaves = [a.clone().requires_grad_() for a in args]
    got = tfah.fused_ag_heads(*leaves)
    (got[0].sum() + 2 * got[1].sum()).backward()
    assert on_card == ["fwd", "bwd"]
    got_grads = [leaf.grad for leaf in leaves]
    leaves = [a.clone().requires_grad_() for a in args]
    want = tfah.ag_heads_plain(*leaves)
    (want[0].sum() + 2 * want[1].sum()).backward()
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    # the kernel rounds h and W to bf16 for dh and dW as the plain
    # version's autograd does
    for g_, leaf in zip(got_grads, leaves):
        _close(g_, leaf.grad, rel=1e-2)


@pytest.mark.parametrize("schedule", ["flash", "hybrid"])
def test_ce_wrappers_pad_and_slice(on_card, monkeypatch, schedule):
    if schedule == "flash":
        def fwd(h16, w16, b, lab):
            assert h16.shape[1] in tfc.KERNEL_H
            on_card.append("fwd")
            return tfc.ce_fwd_plain(h16, w16, b, lab)

        monkeypatch.setattr(tfc, "fused_ce_fwd_kernel", fwd)
        monkeypatch.setattr(tfc, "fused_ce_dh_kernel", lambda *a: (
            on_card.append("dh"), tfc.ce_dh_plain(*a))[1])
        monkeypatch.setattr(tfc, "fused_ce_dwdb_kernel", lambda *a: (
            on_card.append("dwdb"), tfc.ce_dwdb_plain(*a))[1])
        fn, plain = tfc.fused_linear_ce, tfc.fused_linear_ce_plain
    else:
        def fwd(h16, w16, b, lab):
            assert h16.shape[1] in tfc.KERNEL_H
            on_card.append("fwd")
            return tfc.ce_mat_fwd_plain(h16, w16, b, lab)

        monkeypatch.setattr(tfc, "HYBRID_KERNELS", tfc.MatFns(
            fwd, lambda *a: (on_card.append("dh"), tfc.ce_mat_dh_plain(*a))[1],
            lambda *a: (on_card.append("dwdb"), tfc.ce_mat_dwdb_plain(*a))[1]))
        fn, plain = tfc.fused_linear_ce_hybrid, tfc.fused_linear_ce_hybrid_plain
    h, w, b, labels, weights = _ce_args(H=48, seed=4)
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    got = fn(*leaves, labels, weights)
    got.backward()
    assert on_card == ["fwd", "dh", "dwdb"]
    got_grads = [leaf.grad for leaf in leaves]
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    want = plain(*leaves, labels, weights)
    want.backward()
    _close(got, want)
    for g_, leaf in zip(got_grads, leaves):
        assert g_.shape == leaf.shape
        _close(g_, leaf.grad, rel=1e-5)


def test_ce_past_its_widest_kernel_raises(on_card):
    """Only a width past CE_H_MAX raises, under every schedule, naming the
    limit, before any launch; 520 and 1000 pad (test below)."""
    h, w, b, labels, weights = _ce_args(M=5, H=4097, V=7)
    for fn in (tfc.fused_linear_ce, tfc.fused_linear_ce_hybrid,
               tfc.fused_linear_ce_xla_bwd):
        with pytest.raises(ValueError, match="up to 4096"):
            fn(h, w, b, labels, weights)
    assert on_card == []


def _wide_stand_ins(monkeypatch, on_card, schedule, Hp):
    """The schedule's kernel launches replaced by stand-ins that check
    they were handed the padded width Hp and compute the plain version."""
    def at(name, fn, width_of):
        def stand_in(*a):
            assert width_of(a) == Hp, (name, width_of(a))
            on_card.append(name)
            return fn(*a)
        return stand_in

    if schedule == "flash":
        for name, fn in (("fwd", tfc.ce_fwd_plain), ("dh", tfc.ce_dh_plain),
                         ("dwdb", tfc.ce_dwdb_plain)):
            monkeypatch.setattr(tfc, f"fused_ce_{name}_kernel",
                                at(name, fn, lambda a: a[0].shape[1]))
        return tfc.fused_linear_ce, tfc.fused_linear_ce_plain
    fwd = (at("fwd", tfc.ce_mat_fwd_plain, lambda a: a[0].shape[1])
           if schedule == "hybrid" else tfc.ce_xla_fwd_plain)
    fns = tfc.MatFns(fwd, at("dh", tfc.ce_mat_dh_plain, lambda a: a[1].shape[1]),
                     at("dwdb", tfc.ce_mat_dwdb_plain, lambda a: a[0].shape[1]))
    if schedule == "hybrid":
        monkeypatch.setattr(tfc, "HYBRID_KERNELS", fns)
        return tfc.fused_linear_ce_hybrid, tfc.fused_linear_ce_hybrid_plain
    monkeypatch.setattr(tfc, "XLA_BWD_KERNELS", fns)
    return tfc.fused_linear_ce_xla_bwd, tfc.fused_linear_ce_xla_bwd_plain


@pytest.mark.parametrize("schedule", ["flash", "hybrid", "xla_bwd"])
@pytest.mark.parametrize("H,Hp", [(520, 576), (1000, 1024)])
def test_ce_wrappers_pad_past_512(on_card, monkeypatch, schedule, H, Hp):
    """Past 512 each CE schedule's wrapper pads h and W to the next
    multiple of 64, launches each of its kernels once (the XLA forward's
    forward is plain: its two backward kernels), and returns the unpadded
    plain loss and gradients."""
    fn, plain = _wide_stand_ins(monkeypatch, on_card, schedule, Hp)
    h, w, b, labels, weights = _ce_args(H=H, seed=5)
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    got = fn(*leaves, labels, weights)
    got.backward()
    assert on_card == (["dh", "dwdb"] if schedule == "xla_bwd"
                       else ["fwd", "dh", "dwdb"])
    got_grads = [leaf.grad for leaf in leaves]
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    want = plain(*leaves, labels, weights)
    want.backward()
    _close(got, want)
    for g_, leaf in zip(got_grads, leaves):
        assert g_.shape == leaf.shape
        _close(g_, leaf.grad, rel=1e-5)


def test_logits_wrappers_pad(on_card, monkeypatch):
    h, w, b = _logits_args(H=48, seed=6)

    def topk(h_, w_t, b_, k, plan=None):
        assert h_.shape[1] % 32 == 0 and w_t.shape[1] == h_.shape[1]
        on_card.append("topk")
        return tflt.fused_logits_top_k_plain(h_, w_t.t(), b_, k)

    def int8(hq, hs, wq, ws, b_, k, plan=None):
        assert hq.shape[1] % 64 == 0 and wq.shape[0] == hq.shape[1]
        assert wq.t().is_contiguous()
        on_card.append("int8")
        return tflt.int8_top_k_plain(hq, hs, wq, ws, b_, k)

    def sample(h_, w_t, b_, seed, step, temperature=1.0, row0=0, plan=None):
        assert h_.shape[1] % 32 == 0
        on_card.append("sample")
        return tflt.fused_logits_sample_plain(h_, w_t.t(), b_, seed, step,
                                              temperature, row0)

    monkeypatch.setattr(tflt, "logits_top_k_kernel", topk)
    monkeypatch.setattr(tflt, "int8_top_k_kernel", int8)
    monkeypatch.setattr(tflt, "sample_kernel", sample)
    with torch.no_grad():
        got = tflt.fused_logits_top_k(h, w, b, 3)
        want = tflt.fused_logits_top_k_plain(h, w, b, 3)
        assert torch.equal(got[1], want[1])
        _close(got[2], want[2])
        wq, ws = tflt.quantize_logits_weights(w.float())
        got8 = tflt.fused_logits_top_k_int8(h.float(), wq, ws, b, 3)
        for a, e in zip(got8, tflt.fused_logits_top_k_int8_plain(
                h.float(), wq, ws, b, 3)):
            assert torch.equal(a, e)
        assert torch.equal(tflt.fused_logits_sample(h, w, b, 5, 2, 0.9),
                           tflt.fused_logits_sample_plain(h, w, b, 5, 2, 0.9))
    assert on_card == ["topk", "int8", "sample"]


def test_lstm_step_wrapper_takes_the_plan_of_plan_rows(on_card, monkeypatch):
    """Decode over ranks: a share of 768 rows of a 1536-row batch takes
    the whole batch's units a warpgroup (64, where 768 rows alone take
    32), on a grid of its own rows."""
    plans = []

    def kernel(x, c, h, w, b, forget_bias, plan):
        plans.append(plan)
        return tfst.fused_lstm_step_plain(x, c, h, w, b, forget_bias)

    monkeypatch.setattr(tfst, "lstm_step_kernel", kernel)
    args = _lstm_step_args(768, 256, 512, seed=9)
    tfst.fused_lstm_step(*args)
    tfst.fused_lstm_step(*args, plan_rows=1536)
    assert [p.units for p in plans] == [32, 64]
    assert plans[1] == tfst.lstm_step_geometry(768, 256, 512, 64)
    assert tfst.lstm_step_plan(1536, 256, 512).units == 64
