"""The port's CUDA kernels on the card: each against its plain version,
the lowest-index tie rule, the wrappers' checks and launch counts, and a
small decode through the kernels against the same decode through the
plain versions.

Every test needs an NVIDIA GPU with nvcc and skips without one.  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vae_captioning_tpu.config import Config
from vae_captioning_tpu.data.vocabulary import Vocabulary
from vae_captioning_torch import _ext
from vae_captioning_torch.bridge import flax_shapes, load_flax_params
from vae_captioning_torch.inference import PLAIN_OPS, make_decode_fns
from vae_captioning_torch.models.cvae import CVAEModel
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_top_k, fused_logits_top_k_plain)
from vae_captioning_torch.ops.fused_lstm_step import (fused_lstm_step,
                                                      fused_lstm_step_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _lstm_args(dev, N, E, H, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((N, E), generator=g, device=dev).to(torch.bfloat16),
            torch.randn((N, H), generator=g, device=dev),
            torch.randn((N, H), generator=g, device=dev),
            (0.1 * torch.randn((E + H, 4 * H), generator=g, device=dev)
             ).to(torch.bfloat16),
            0.1 * torch.randn((4 * H,), generator=g, device=dev))


@pytest.mark.parametrize("N,E,H", [(200, 64, 96), (1, 32, 32), (513, 256, 512)])
def test_lstm_step_kernel_matches_plain(dev, N, E, H):
    args = _lstm_args(dev, N, E, H, seed=N)
    before = _ext.LAUNCHES["fused_lstm_step"]
    got = fused_lstm_step(*args)
    want = fused_lstm_step_plain(*args)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["fused_lstm_step"] == before + 1
    for a, r in zip(got, want):   # f32 sums in another order
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 10, 16])
def test_logits_top_k_kernel_matches_plain(dev, k):
    g = torch.Generator(device=dev).manual_seed(k)
    M, H, V = 300, 64, 4001
    h = torch.randn((M, H), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((H, V), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((V,), generator=g, device=dev)
    before = _ext.LAUNCHES["fused_logits_top_k"]
    vals, idx, lse = fused_logits_top_k(h, w, b, k)
    p_vals, p_idx, p_lse = fused_logits_top_k_plain(h, w, b, k)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["fused_logits_top_k"] == before + 1
    torch.testing.assert_close(vals, p_vals, rtol=1e-5, atol=0)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)
    # unit-variance logits over 4001 columns: no near-ties at this seed
    assert torch.equal(idx, p_idx)


def test_logits_top_k_ties_go_to_the_lowest_index(dev):
    M, H, V = 70, 32, 3000
    b = torch.zeros(V, device=dev)
    b[[2500, 3, 1200]] = 2.0
    vals, idx, _ = fused_logits_top_k(
        torch.ones((M, H), device=dev, dtype=torch.bfloat16),
        torch.zeros((H, V), device=dev, dtype=torch.bfloat16), b, 5)
    assert idx[:, :3].tolist() == [[3, 1200, 2500]] * M
    assert idx[:, 3:].tolist() == [[0, 1]] * M


def test_wrappers_check_their_inputs(dev):
    x, c, h, w, b = _lstm_args(dev, 8, 32, 32)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_lstm_step(x.float(), c, h, w, b)
    with pytest.raises(ValueError, match="multiples of 32"):
        fused_lstm_step(x[:, :16].contiguous(), c, h, w[16:].contiguous(), b)
    with pytest.raises(ValueError, match="k=17"):
        fused_logits_top_k(h.to(torch.bfloat16), w[:32, :64].contiguous(),
                           b[:64].contiguous(), 17)


def test_decode_through_kernels_matches_plain_decode(dev):
    cfg = Config(embed_size=64, latent_size=16, decoder_hidden=64,
                 gen_z_samples=4, prior="AG", use_c_v=True, gen_max_len=8,
                 beam_size=3, std=0.0)
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(500)])
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    rng = np.random.default_rng(0)
    load_flax_params(model, {k: rng.normal(0, 0.3, size=s).astype(np.float32)
                             for k, s in flax_shapes(model).items()})
    model = model.to(dev)
    feats = torch.randn((16, 4096), device=dev)
    c_v = (torch.rand((16, 90), device=dev) < 0.05).float()
    kernel = make_decode_fns(model, cfg, vocab)
    plain = make_decode_fns(model, cfg, vocab, ops=PLAIN_OPS)
    for name in ("beam_search", "greedy"):
        got, want = kernel[name](feats, c_v), plain[name](feats, c_v)
        assert torch.equal(got.tokens, want.tokens), name
        if got.scores is not None:
            torch.testing.assert_close(got.scores, want.scores, rtol=1e-4,
                                       atol=0)
