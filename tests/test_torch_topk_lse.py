"""Port of the exact top-k + logsumexp over materialised logits: its plain
version (what the wrapper runs on CPU tensors) against the JAX Pallas
kernel ``top_k_logsumexp_pallas`` in interpret mode (past the beams'
lists, against ``top_k_logsumexp_xla``), the wrapper's routing on a card
(the warp lists to k = 32, the select past them, its workspace) with the
library stood in, and the step_fn form of the port's beam search against
the JAX ``beam_search(step_fn, use_pallas=False)``.

Values are copied on both sides, so indices and values must be equal;
the logsumexp is an f32 sum in another order (rtol 1e-6).  Beam search:
tokens equal, scores within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import decoding as jdec
from vae_captioning_tpu.ops import topk_pallas as jtp
from vae_captioning_torch import _ext
from vae_captioning_torch.ops import decoding as tdec
from vae_captioning_torch.ops import topk_lse as tlse
from vae_captioning_torch.ops.topk_lse import (top_k_logsumexp,
                                               top_k_logsumexp_plain)

from test_torch_decoding import (BOS, EOS, _init, _jax_step, _table,
                                 _torch_step)


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jtp.pl, "pallas_call", patched)
    # a fresh jit of the un-jitted function, traced under the patch
    yield jax.jit(jtp.top_k_logsumexp_pallas.__wrapped__, static_argnums=1)


def _logits(N, V, seed):
    """Unit normals with planted ties: each row's maximum at three random
    columns (and, in even rows, at columns 127 and 129 as well), and a
    second value at two more."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, V)).astype(np.float32)
    top = x.max(axis=1) + 1.0
    for r in range(N):
        cols = rng.choice(V, size=5, replace=False)
        x[r, cols[:3]] = top[r]
        x[r, cols[3:]] = top[r] - 0.5
    if V > 130:   # even rows: the maximum also at 127 and 129
        x[::2, 127] = x[::2, 129] = top[::2]
    return x


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("V", [128, 1000, 4000])
@pytest.mark.parametrize("N", [8, 13, 300])
def test_plain_matches_jax_kernel(interpreted, N, V, k):
    x = _logits(N, V, seed=N * V + k)
    vals, idx, lse = top_k_logsumexp_plain(torch.from_numpy(x), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    jv, ji, jl = interpreted(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-6)
    # the planted ties: the lowest of the three tied columns comes first
    first = np.flatnonzero(x[0] == x[0].max())[0]
    assert int(idx[0, 0]) == first


def _logits_with_neg_inf(N, V, k, seed):
    """:func:`_logits` with -inf entries where the card kernel reads a
    row in parts: the first half of row 0 (its head and first chunks), the
    last third of row 1 (its tail), every 7th column of odd rows, and all
    but k columns of row 2 (exactly k finite values, the least the
    contract allows)."""
    x = _logits(N, V, seed)
    rng = np.random.default_rng(seed + 1)
    x[0, :V // 2] = -np.inf
    x[1, V - V // 3:] = -np.inf
    x[3::2, ::7] = -np.inf
    keep = rng.choice(V, size=k, replace=False)
    row = np.full(V, -np.inf, dtype=np.float32)
    row[keep] = x[2, keep]
    x[2] = row
    return x


@pytest.mark.parametrize("N,V,k", [(8, 11519, 1), (8, 11519, 3),
                                   (13, 11519, 10), (16, 11519, 16),
                                   (9, 1000, 3), (40, 11519, 5),
                                   (24, 4000, 16)]
                         + [(8, V, k) for k in (33, 40, 64, 65, 100)
                            for V in (1000, 11519)])
@pytest.mark.parametrize("neg_inf", [False, True])
def test_plain_matches_jax_kernel_ragged_rows_and_neg_inf(interpreted, N, V,
                                                          k, neg_inf):
    """The beam's ragged vocabulary (V = 11519: every row but the first
    starts off a 16-byte boundary in the card kernel) and rows with -inf
    entries, at least k finite values each; past k = 32 the lists the
    card's select takes (beams of 33 to 100)."""
    x = (_logits_with_neg_inf(N, V, k, seed=V + k) if neg_inf
         else _logits(N, V, seed=V + k))
    vals, idx, lse = top_k_logsumexp_plain(torch.from_numpy(x), k)
    jv, ji, jl = interpreted(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-6)
    assert np.isfinite(vals.numpy()).all()
    if neg_inf:
        keep = np.flatnonzero(np.isfinite(x[2]))
        assert sorted(idx[2].tolist()) == keep.tolist()


@pytest.mark.parametrize("N,V,k", [(6, 1000, 256), (5, 11519, 256),
                                   (4, 1000, 1000), (3, 11519, 600)])
@pytest.mark.parametrize("neg_inf", [False, True])
def test_plain_matches_jax_xla_past_the_beams(N, V, k, neg_inf):
    """Lists wider than any beam (256, 600, k = V), which the card's select
    also takes, against the JAX package's ``top_k_logsumexp_xla``
    (``jax.lax.top_k``: ties to the lowest index); the Pallas kernel's k
    unrolled passes are too slow to trace at these k."""
    x = (_logits_with_neg_inf(N, V, min(k, V // 2), seed=V + k) if neg_inf
         else _logits(N, V, seed=V + k))
    vals, idx, lse = top_k_logsumexp_plain(torch.from_numpy(x), k)
    jv, ji, jl = jtp.top_k_logsumexp_xla(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-6)


class _FakeLibrary:
    """The C entry points of csrc/topk_lse.cu as the wrapper calls them:
    each call and its sizes recorded, nothing launched."""

    def __init__(self, workspace):
        self.calls, self.workspace = [], workspace

    def _launch(self, name, x, vals, idx, lse, *rest):
        self.calls.append((name, rest))
        return 0

    def vct_top_k_logsumexp(self, x, vals, idx, lse, N, V, pitch, k, sms, stream):
        return self._launch("lists", x, vals, idx, lse, N, V, pitch, k)

    def vct_top_k_logsumexp_select_workspace(self, N, V, k, sms):
        self.calls.append(("workspace", (N, V, k, sms)))
        return self.workspace

    def vct_top_k_logsumexp_select(self, x, vals, idx, lse, work, N, V, pitch, k, sms,
                                   stream):
        return self._launch("select", x, vals, idx, lse, work, N, V, pitch, k)


@pytest.fixture()
def on_card(monkeypatch):
    """The wrapper's kernel branch on CPU tensors: ``_ext.on_cpu`` says
    "CUDA", the library is a _FakeLibrary (returned, its workspace bytes
    settable)."""
    lib = _FakeLibrary(0)
    monkeypatch.setattr(_ext, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_ext, "sm_count", lambda index=None: 132)
    monkeypatch.setattr(_ext, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_ext, "library", lambda: lib)
    return lib


@pytest.mark.parametrize("k,entry", [(1, "lists"), (16, "lists"), (32, "lists"),
                                     (33, "select"), (40, "select"), (100, "select"),
                                     (300, "select")])
def test_wrapper_takes_the_lists_to_32_and_the_select_past(on_card, k, entry):
    """Up to K_LIST (32) the warp lists' entry point, past it the select's,
    which asks its workspace first (none where it reports 0 bytes); one
    launch counted either way."""
    x = torch.from_numpy(_logits(3, 400, seed=k))
    before = _ext.LAUNCHES["top_k_logsumexp"]
    vals, idx, lse = top_k_logsumexp(x, k)
    assert _ext.LAUNCHES["top_k_logsumexp"] == before + 1
    assert vals.shape == idx.shape == (3, k) and lse.shape == (3,)
    assert idx.dtype == torch.int32
    names = [name for name, _ in on_card.calls]
    if entry == "lists":
        assert names == ["lists"] and on_card.calls[0][1] == (3, 400, 400, k)
    else:
        assert names == ["workspace", "select"]
        assert on_card.calls[0][1] == (3, 400, k, 132)
        assert on_card.calls[1][1] == (None, 3, 400, 400, k)


def test_select_workspace_is_allocated_as_reported(on_card):
    """The bytes the select's workspace query reports are allocated and
    handed over; -1 (past 2 GiB) raises ValueError, a negated cudaError_t
    (below -1) raises RuntimeError, and neither launches."""
    x = torch.from_numpy(_logits(4, 900, seed=2))
    on_card.workspace = 8 * 132 * 1024
    top_k_logsumexp(x, 600)
    (_, (work, *rest)), = [c for c in on_card.calls if c[0] == "select"]
    assert work is not None and work != 0 and rest == [4, 900, 900, 600]
    before = _ext.LAUNCHES["top_k_logsumexp"]
    on_card.workspace = -1
    with pytest.raises(ValueError, match="2 GiB"):
        top_k_logsumexp(x, 600)
    on_card.workspace = -2
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        top_k_logsumexp(x, 600)
    assert _ext.LAUNCHES["top_k_logsumexp"] == before


def test_entry_point_follows_k_list():
    assert tlse.K_LIST == 32
    assert [tlse.entry_point(k) for k in (1, 32, 33, 64, 65, 11519)] == (
        ["vct_top_k_logsumexp"] * 2 + ["vct_top_k_logsumexp_select"] * 4)


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(_logits(6, 300, seed=1))
    before = _ext.LAUNCHES["top_k_logsumexp"]
    got = top_k_logsumexp(x, 4)
    assert _ext.LAUNCHES["top_k_logsumexp"] == before
    for a, r in zip(got, top_k_logsumexp_plain(x, 4)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no backward"):
        top_k_logsumexp(x.clone().requires_grad_(), 2)


@pytest.mark.parametrize("K", [1, 3, 5, 10])
@pytest.mark.parametrize("early_exit", [True, False])
def test_beam_search_step_fn_form_matches_jax(K, early_exit):
    """The lookup-table model of tests/test_torch_decoding.py through the
    step_fn forms of both beam searches: the port's takes
    ``top_k_logsumexp`` over the logits, the JAX one XLA's top-k."""
    table = _table(seed=20 + K, eos_shift=1.0)
    init = _init(5, seed=K)
    kw = dict(beam_size=K, bos_id=BOS, eos_id=EOS, max_len=9, len_norm_f=0.7,
              early_exit=early_exit)
    want = jdec.beam_search(_jax_step(table), jnp.asarray(init), len(init),
                            use_pallas=False, **kw)
    got = tdec.beam_search(_torch_step(table), torch.from_numpy(init).long(),
                           len(init), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5)
    assert 1 <= got.steps <= 9


def test_beam_search_top_k_fn_is_the_one_called():
    """``top_k_fn`` replaces the wrapper (the JAX ``use_pallas`` choice)."""
    calls = []

    def counting(x, k):
        calls.append(tuple(x.shape))
        return top_k_logsumexp_plain(x, k)

    table = _table(seed=3)
    init = torch.from_numpy(_init(2)).long()
    tdec.beam_search(_torch_step(table), init, 2, beam_size=3, bos_id=BOS,
                     eos_id=EOS, max_len=4, top_k_fn=counting)
    assert calls and all(shape[0] == 6 for shape in calls)
    with pytest.raises(ValueError, match="step_fn or step_topk_fn"):
        tdec.beam_search(None, init, 2, beam_size=3, bos_id=BOS, eos_id=EOS,
                         max_len=4)

