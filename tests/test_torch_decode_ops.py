"""The decode fns' per-step operations (``inference.DecodeOps``): every
LSTM step of a decode, the three conditioning steps of ``decode_init``
included, goes through the ops it is given; and the reversed-sum plain
versions (``REORDERED_OPS``), the yardstick ``chip_smoke.py`` holds the
kernels' drift against, compute the plain versions' maths rounded
another way."""

import numpy as np
import pytest
import torch

from vae_captioning_tpu.config import Config
from vae_captioning_tpu.data.vocabulary import Vocabulary
from vae_captioning_torch import inference as tinf
from vae_captioning_torch.bridge import flax_shapes, load_flax_params
from vae_captioning_torch.models.cvae import CVAEModel
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_top_k, fused_logits_top_k_plain)
from vae_captioning_torch.ops.fused_lstm_step import (fused_lstm_step,
                                                      fused_lstm_step_plain)

B = 16


@pytest.fixture(scope="module")
def model_cfg():
    cfg = Config(embed_size=64, latent_size=16, decoder_hidden=64,
                 gen_z_samples=4, prior="AG", use_c_v=True, gen_max_len=8,
                 beam_size=3)
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(300)])
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    rng = np.random.default_rng(0)
    load_flax_params(model, {k: rng.normal(0, 0.3, size=s).astype(np.float32)
                             for k, s in flax_shapes(model).items()})
    return cfg, vocab, model


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(B, 4096)).astype(np.float32))
    c_v = torch.from_numpy((rng.random((B, 90)) < 0.05).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(B, 64)).astype(np.float32))
    return (feats, c_v), {"eps": eps}


@pytest.mark.parametrize("name,beam", [("beam_search", 3), ("greedy", 1)])
def test_every_lstm_step_goes_through_the_ops(model_cfg, name, beam):
    cfg, vocab, model = model_cfg
    rows = []

    def lstm_step(x, c, h, w, b):
        assert x.dtype == w.dtype == torch.bfloat16   # cast once, up front
        rows.append(x.shape[0])
        return fused_lstm_step_plain(x, c, h, w, b)

    ops = tinf.DecodeOps(lstm_step, fused_logits_top_k_plain)
    args, kw = _inputs()
    res = tinf.make_decode_fns(model, cfg, vocab, ops=ops)[name](*args, **kw)
    # image, c_v and z conditioning steps on B rows, then one per token
    assert rows == [B] * 3 + [B * beam] * res.steps


def test_reordered_plain_versions_round_another_way():
    g = torch.Generator().manual_seed(0)
    N, E, H, V = 64, 256, 512, 3001
    x = torch.randn((N, E), generator=g).to(torch.bfloat16)
    c = torch.randn((N, H), generator=g)
    h = torch.tanh(torch.randn((N, H), generator=g))
    w = (0.05 * torch.randn((E + H, 4 * H), generator=g)).to(torch.bfloat16)
    b = 0.1 * torch.randn((4 * H,), generator=g)
    plain = fused_lstm_step_plain(x, c, h, w, b)
    reordered = tinf.REORDERED_OPS.lstm_step(x, c, h, w, b)
    for p, r in zip(plain, reordered):
        torch.testing.assert_close(r, p, rtol=0, atol=1e-5)
    assert any(bool((p != r).any()) for p, r in zip(plain, reordered))

    hw = (0.05 * torch.randn((H, V), generator=g)).to(torch.bfloat16)
    hb = 0.1 * torch.randn((V,), generator=g)
    hb16 = h.to(torch.bfloat16)
    p_vals, p_idx, p_lse = fused_logits_top_k_plain(hb16, hw, hb, 5)
    vals, idx, lse = tinf.REORDERED_OPS.logits_top_k(hb16, hw, hb, 5)
    torch.testing.assert_close(vals, p_vals, rtol=1e-5, atol=0)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)
    assert torch.equal(idx, p_idx)


@pytest.mark.parametrize("name", ["beam_search", "greedy"])
def test_reordered_decode_matches_plain_decode(model_cfg, name):
    """At these widths and seeds no choice is near-even, so the two
    roundings decode the same captions."""
    cfg, vocab, model = model_cfg
    args, kw = _inputs(seed=1)
    plain = tinf.make_decode_fns(model, cfg, vocab, ops=tinf.PLAIN_OPS)[name]
    reordered = tinf.make_decode_fns(model, cfg, vocab,
                                     ops=tinf.REORDERED_OPS)[name]
    want, got = plain(*args, **kw), reordered(*args, **kw)
    assert torch.equal(got.tokens, want.tokens)
    if want.scores is not None:
        torch.testing.assert_close(got.scores, want.scores, rtol=1e-5, atol=0)


def test_inference_kernel_wrappers_refuse_gradients():
    """The decode kernels have no backward and write their outputs
    through data_ptr(), so a gradient through them would be silently
    lost on the card: the wrappers raise under grad mode on every
    device, and run under no_grad."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, generator=g).to(torch.bfloat16)
    c, h = torch.randn(4, 32, generator=g), torch.randn(4, 32, generator=g)
    w = torch.randn(64, 128, generator=g).requires_grad_()
    b = torch.zeros(128)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm_step(x, c, h, w, b)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_logits_top_k(h.to(torch.bfloat16), w[:32].detach().requires_grad_(),
                           torch.zeros(128), 3)
    with torch.no_grad():
        fused_lstm_step(x, c, h, w, b)
        fused_logits_top_k(h.to(torch.bfloat16), w[:32], torch.zeros(128), 3)
    # inputs that need no gradient pass under grad mode too
    fused_lstm_step(x, c, h, w.detach(), b)


@pytest.mark.parametrize("weights_need_grad", [True, False])
def test_lstm_cell_takes_the_kernel_unless_a_gradient_is_wanted(
        monkeypatch, weights_need_grad):
    """Under grad mode the cell runs the differentiable plain step only
    when an input or weight requires grad; otherwise it goes through the
    decode kernel's wrapper, as under no_grad."""
    from vae_captioning_torch.ops import lstm as tlstm
    calls = []

    def spy(*args):
        calls.append(args[0].shape[0])
        return fused_lstm_step(*args)

    monkeypatch.setattr(tlstm, "fused_lstm_step", spy)
    torch.manual_seed(0)
    cell = tlstm.LSTMCell(32, 32).requires_grad_(weights_need_grad)
    x, c, h = torch.randn(4, 32), torch.zeros(4, 32), torch.zeros(4, 32)
    (new_c, new_h), _ = cell((c, h), x)
    assert calls == ([] if weights_need_grad else [4])
    assert new_h.requires_grad == weights_need_grad
    with torch.no_grad():
        (c2, h2), _ = cell((c, h), x)
    assert calls[-1] == 4
    torch.testing.assert_close(h2, new_h.detach(), rtol=0, atol=0)
