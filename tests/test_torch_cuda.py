"""The port's CUDA kernels on the card: each against its plain version
(also at widths no kernel instance takes, which the wrappers pad),
the lowest-index tie rule, the wrappers' checks and launch counts, the
sampler's bits and law, a small decode in every mode (bf16, int8,
unfused, sampled) and a few train steps (Normal prior, AG prior, GMM prior
with the flash, hybrid and XLA-forward CE) through the kernels against
the same through the plain versions, and the fused z generator's bits
against the plain generator's.

Every test needs an NVIDIA GPU with nvcc and skips without one.  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.bridge import flax_shapes, load_flax_params
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.vocabulary import Vocabulary
from vae_captioning_torch.inference import PLAIN_OPS, make_decode_fns
from vae_captioning_torch.models.cvae import CVAEModel
from vae_captioning_torch.ops.fused_ag_heads import (ag_heads_bwd_kernel,
                                                     ag_heads_fwd_kernel,
                                                     ag_heads_plain,
                                                     fused_ag_heads)
from vae_captioning_torch.ops.fused_ag_heads import prepare as ag_prepare
from vae_captioning_torch.ops.fused_ce import (
    bwd_cluster, ce_bwd_plan, ce_fwd_plain, ce_mat_dh_kernel, ce_mat_dwdb_kernel,
    ce_mat_fwd_kernel, ce_mat_fwd_plain,
    fused_ce_dh_kernel, fused_ce_dwdb_kernel, fused_ce_fwd_kernel,
    fused_linear_ce, fused_linear_ce_hybrid, fused_linear_ce_hybrid_plain,
    fused_linear_ce_plain, fused_linear_ce_xla_bwd,
    fused_linear_ce_xla_bwd_plain, fwd_block, fwd_cluster, pad_ce, ce_width, prepare)
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_sample, fused_logits_top_k, fused_logits_top_k_int8,
    fused_logits_top_k_int8_plain, fused_logits_top_k_plain,
    block_shape, int8_logits, int8_logits_kernel, int8_top_k_kernel, int8_top_k_plain,
    logits_kernel, logits_pitch, logits_plan, logits_top_k_kernel,
    quantize_logits_weights, quantize_rows, sample_kernel, sample_scores)
from vae_captioning_torch.ops.fused_lstm_seq import (fused_lstm_seq,
                                                     fused_lstm_seq_plain)
from vae_captioning_torch.ops.fused_lstm_step import (fused_lstm_step,
                                                      fused_lstm_step_plain,
                                                      lstm_step_geometry,
                                                      lstm_step_kernel,
                                                      lstm_step_layout)
from vae_captioning_torch.ops.fused_z import (fused_z, fused_z_eps,
                                              fused_z_plain, philox_bits,
                                              philox_normals, z_bwd_kernel,
                                              z_fwd_kernel)
from vae_captioning_torch.ops.topk_lse import (top_k_logsumexp,
                                               top_k_logsumexp_plain)

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


@pytest.mark.parametrize("N,E,H", [(200, 64, 96), (1, 32, 32), (513, 256, 512),
                                   (1536, 256, 512), (5120, 256, 512),
                                   (65, 256, 512), (300, 32, 96),
                                   (70, 256, 1536), (70, 40, 48),
                                   (513, 300, 500)])
def test_lstm_step_kernel_matches_plain(dev, N, E, H):
    args = _lstm_args(dev, N, E, H, seed=N)
    before = _ext.LAUNCHES["fused_lstm_step"]
    got = fused_lstm_step(*args)
    want = fused_lstm_step_plain(*args)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["fused_lstm_step"] == before + 1
    for a, r in zip(got, want):   # f32 sums in another order
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("units", [64, 32])
@pytest.mark.parametrize("N,E,H", [(1536, 256, 512), (65, 32, 96),
                                   (70, 256, 640), (70, 256, 1536)])
def test_lstm_step_kernel_geometries_match_plain(dev, units, N, E, H):
    """Both unit widths of the kernel, whichever lstm_step_plan picks, at
    a train width, a ragged one (H % 2U != 0, E % 64 != 0) and two whose
    A is taken in chunks (E + H past the resident room: at U = 64 only,
    and at both widths); the layout fits one block's shared memory with a
    ring of two to four stages."""
    args = _lstm_args(dev, N, E, H, seed=N + units)
    chunk, stages, smem = lstm_step_layout(E, H, units)
    assert smem <= 232448 and 2 <= stages <= 4
    assert 1 <= chunk <= -(-E // 64) + -(-H // 64)
    got = lstm_step_kernel(*args, 1.0, lstm_step_geometry(N, E, H, units))
    want = fused_lstm_step_plain(*args)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
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


def _logits_args(dev, M, H, V, seed):
    """h [M, H] bf16, the head transposed w_t [V, H] bf16 (as the decode
    stores it), b [V] f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev)).to(torch.bfloat16)
    w_t = (0.05 * torch.randn((V, H), generator=g, device=dev)).to(torch.bfloat16)
    return h, w_t, 0.1 * torch.randn((V,), generator=g, device=dev)


def _assert_top_k(got, want_k1, k):
    """Values and lse to rtol 1e-5 (f32 sums in another order); indices
    equal in every row whose plain top-(k+1) values hold no gap of 1e-4."""
    p_vals, p_idx, p_lse = want_k1
    torch.testing.assert_close(got[0], p_vals[:, :k], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], p_lse, rtol=1e-5, atol=0)
    near = ((p_vals[:, :k] - p_vals[:, 1:]) <= 1e-4).any(dim=1)
    assert bool(((got[1] != p_idx[:, :k]).any(dim=1) & ~near).sum() == 0)


@pytest.mark.parametrize("H,eb,k,rows,resident", [
    (512, 2, 3, 128, True), (512, 2, 10, 128, True), (512, 2, 16, 64, True),
    (640, 2, 3, 128, True), (672, 2, 3, 64, True), (1024, 2, 3, 64, True),
    (1280, 2, 1, 64, True), (1312, 2, 1, 64, False), (4096, 2, 3, 64, False),
    (512, 1, 10, 128, True), (1024, 1, 10, 128, True), (1280, 1, 3, 128, True),
    (1344, 1, 3, 64, True), (2560, 1, 3, 64, True), (2624, 1, 3, 64, False),
    (96, 2, 3, 128, True), (32, 2, 16, 64, True)])
def test_plan_block_shape_follows_the_width(dev, H, eb, k, rows, resident):
    """The kernels' block shape: 128 rows where they fit beside four ring
    stages and the lists hold at most 10 (the decode's H = 512 in bf16
    and int8); else 64 rows, resident beside four stages or streamed;
    within 227 KB of shared memory."""
    assert block_shape(H, eb, k) == (rows, resident)
    smem = _ext.library().vct_fused_logits_top_k_smem(H, int(eb == 1), rows, int(resident))
    assert 0 < smem <= 232448


def test_plan_takes_the_forced_rows(dev):
    assert block_shape(512, 2, 1, 64) == (64, True)
    assert logits_plan(512, 512, 11500, 1, 2, rows=64).parts == 2 * logits_plan(
        512, 512, 11500, 1, 2, rows=64).chunks
    with pytest.raises(ValueError, match="rows=128"):
        logits_plan(512, 1024, 11500, 3, rows=128)
    with pytest.raises(ValueError, match="rows=128"):
        block_shape(512, 2, 16, 128)


@pytest.mark.parametrize("M,H,V,k,rows", [
    (1536, 512, 11500, 3, 0), (512, 512, 11519, 1, 64),
    (512, 512, 11500, 10, 0), (1000, 512, 11519, 3, 64),
    (1, 512, 11519, 3, 0), (65, 512, 11500, 16, 0),
    (300, 96, 11519, 10, 0), (65, 1024, 11500, 3, 0),
    (65, 2048, 11519, 10, 0), (200, 512, 130, 16, 0)])
def test_logits_top_k_kernel_geometries_match_plain(dev, M, H, V, k, rows):
    """Every block shape the plan picks (128 rows resident, the box count
    at compile time at H = 512; 64 rows resident at H = 1024 and for
    lists of 16; 64 rows streamed at H = 2048) and the forced 64-row
    blocks, at one row, one row past a block, H = 96 and a vocabulary of
    two tiles; twice, bit for bit."""
    h, w_t, b = _logits_args(dev, M, H, V, seed=M + H + k)
    plan = logits_plan(M, H, V, k, 2, rows=rows)
    got = logits_top_k_kernel(h, w_t, b, k, plan)
    _assert_top_k(got, fused_logits_top_k_plain(h, w_t.t(), b, k + 1), k)
    again = logits_top_k_kernel(h, w_t, b, k, plan)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("M,H,V,k,rows", [
    (512, 512, 11500, 1, 64), (1536, 512, 11519, 10, 0),
    (1, 512, 11519, 16, 0), (65, 1024, 11500, 3, 0),
    (65, 2624, 11519, 10, 0)])
def test_int8_kernel_geometries_match_plain(dev, M, H, V, k, rows):
    """The int8 kernel at every block shape: values and indices bit for
    bit, lse to 1e-5."""
    h, w_t, b = _logits_args(dev, M, H, V, seed=M + H + k)
    hq, hs = quantize_rows(h.float())
    wq, ws = quantize_logits_weights(w_t.t().float())
    plan = logits_plan(M, H, V, k, 1, rows=rows)
    vals, idx, lse = int8_top_k_kernel(hq, hs, wq, ws, b, k, plan)
    p_vals, p_idx, p_lse = int8_top_k_plain(hq, hs, wq, ws, b, k)
    assert torch.equal(idx, p_idx) and torch.equal(vals, p_vals)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)


@pytest.mark.parametrize("M,H,V", [(512, 512, 11500), (1, 512, 11519),
                                   (65, 96, 11500), (65, 1024, 11519),
                                   (33, 2048, 130)])
def test_sample_kernel_geometries_match_plain(dev, M, H, V):
    """The sampler at its block shapes (64 rows, h resident; streamed at
    H = 2048): tokens equal the plain sampler's outside rows whose top two
    scores lie within 1e-4."""
    h, w_t, b = _logits_args(dev, M, H, V, seed=M + H)
    got = sample_kernel(h, w_t, b, 77, 3, 0.9, 0)
    scores = sample_scores(h, w_t.t(), b, 77, 3, 0.9)
    top2 = scores.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert torch.equal(got[clear], scores.argmax(dim=1).int()[clear])


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
    with pytest.raises(ValueError, match="disagree"):
        fused_lstm_step(x[:, :16].contiguous(), c, h, w, b)
    with pytest.raises(ValueError, match="k=65"):     # only k > V raises
        fused_logits_top_k(h.to(torch.bfloat16), w[:32, :64].contiguous(),
                           b[:64].contiguous(), 65)


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
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((16, 4096), generator=g, device=dev)
    c_v = (torch.rand((16, 90), generator=g, device=dev) < 0.05).float()
    kernel = make_decode_fns(model, cfg, vocab)
    plain = make_decode_fns(model, cfg, vocab, ops=PLAIN_OPS)
    for name in ("beam_search", "greedy"):
        got, want = kernel[name](feats, c_v), plain[name](feats, c_v)
        assert torch.equal(got.tokens, want.tokens), name
        if got.scores is not None:
            torch.testing.assert_close(got.scores, want.scores, rtol=1e-4,
                                       atol=0)


@pytest.mark.parametrize("H", [48, 500])
def test_logits_kernels_at_odd_widths_match_plain(dev, H):
    """The bf16 top-k, int8 top-k and sampler wrappers at an H their
    kernels are not built for: the wrappers pad h and W^T with zero
    columns (exact), launch once each, and agree with the plain versions
    as at the built widths."""
    M, V, k = 300, 4001, 3
    g = torch.Generator(device=dev).manual_seed(H)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev))
    w = torch.randn((H, V), generator=g, device=dev) * 0.2
    b = torch.randn((V,), generator=g, device=dev)
    h16, w16 = h.to(torch.bfloat16), w.to(torch.bfloat16)
    wq, ws = quantize_logits_weights(w)
    before = dict(_ext.LAUNCHES)
    vals, idx, lse = fused_logits_top_k(h16, w16, b, k)
    p_vals, p_idx, p_lse = fused_logits_top_k_plain(h16, w16, b, k)
    q = fused_logits_top_k_int8(h, wq, ws, b, k)
    p_q = fused_logits_top_k_int8_plain(h, wq, ws, b, k)
    tokens = fused_logits_sample(h16, w16, b, 9, 2, 0.8)
    torch.cuda.synchronize()
    for name in ("fused_logits_top_k", "fused_logits_top_k_int8",
                 "fused_logits_sample"):
        assert _ext.LAUNCHES[name] == before[name] + 1, name
    torch.testing.assert_close(vals, p_vals, rtol=1e-5, atol=0)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)
    assert torch.equal(idx, p_idx)
    # int8: exact integer products, so values and indices bit for bit
    assert torch.equal(q[0], p_q[0]) and torch.equal(q[1], p_q[1])
    torch.testing.assert_close(q[2], p_q[2], rtol=1e-5, atol=0)
    scores = sample_scores(h16, w16, b, 9, 2, 0.8)
    top2 = scores.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert torch.equal(tokens[clear], scores.argmax(dim=1).int()[clear])


@pytest.mark.parametrize("kind", ["lstm_step", "bf16", "int8"])
def test_a_share_of_rows_takes_the_whole_batchs_plan(dev, kind):
    """The LSTM step's units a warpgroup and the top-k kernels' vocab
    chunks depend on the row count (at 768 and 1536 rows both differ),
    and so does the order of a row's sums: half of a batch given the
    whole batch's count (``plan_rows``) returns every row bit for bit as
    the whole batch does (decode over ranks)."""
    M, H, V, k = 1536, 512, 11500, 3
    g = torch.Generator(device=dev).manual_seed(31)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev))
    w = torch.randn((H, V), generator=g, device=dev) * 0.05
    b = torch.randn((V,), generator=g, device=dev)
    if kind == "lstm_step":
        x, c, hh, wl, bl = _lstm_args(dev, M, 256, H, seed=32)
        fn = lambda r, **kw: fused_lstm_step(x[r], c[r], hh[r], wl, bl, **kw)  # noqa: E731
        whole = fn(slice(None))
        half = fn(slice(M // 2, None), plan_rows=M)
        torch.cuda.synchronize()
        for a, r in zip(half, whole):
            assert torch.equal(a, r[M // 2:])
        return
    if kind == "int8":
        wq, ws = quantize_logits_weights(w)
        fn = lambda x, **kw: fused_logits_top_k_int8(x, wq, ws, b, k, **kw)  # noqa: E731
    else:
        w16 = w.to(torch.bfloat16)
        fn = lambda x, **kw: fused_logits_top_k(x.to(torch.bfloat16), w16, b, k, **kw)  # noqa: E731
    whole = fn(h)
    half = fn(h[M // 2:].contiguous(), plan_rows=M)
    torch.cuda.synchronize()
    for a, r in zip(half, whole):
        assert torch.equal(a, r[M // 2:])


@pytest.mark.parametrize("widths", [(64, 64), (40, 48)], ids=["built", "odd"])
def test_multi_layer_decode_through_kernels_matches_plain(dev, widths):
    """A 2-layer decoder: every step runs the LSTM step kernel once a
    layer (the conditioning steps too), the logits kernel once, and the
    tokens and beam scores equal the plain versions' decode."""
    E, H = widths
    cfg = Config(embed_size=E, latent_size=16, decoder_hidden=H,
                 encoder_hidden=H, gen_z_samples=4, prior="AG", use_c_v=True,
                 gen_max_len=8, beam_size=3, std=0.0, decoder_rnn_layers=2)
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(500)])
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    rng = np.random.default_rng(1)
    load_flax_params(model, {k: rng.normal(0, 0.3, size=s).astype(np.float32)
                             for k, s in flax_shapes(model).items()})
    model = model.to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn((16, 4096), generator=g, device=dev)
    c_v = (torch.rand((16, 90), generator=g, device=dev) < 0.05).float()
    kernel = make_decode_fns(model, cfg, vocab)
    plain = make_decode_fns(model, cfg, vocab, ops=PLAIN_OPS)
    for name in ("beam_search", "greedy"):
        before = dict(_ext.LAUNCHES)
        got = kernel[name](feats, c_v)
        torch.cuda.synchronize()
        steps = (_ext.LAUNCHES["fused_logits_top_k"]
                 - before["fused_logits_top_k"])
        assert steps == got.steps
        # 3 conditioning steps (image, c_v, z) and every token step, x 2
        assert (_ext.LAUNCHES["fused_lstm_step"] - before["fused_lstm_step"]
                == 2 * (3 + got.steps))
        want = plain[name](feats, c_v)
        assert torch.equal(got.tokens, want.tokens), name
        if got.scores is not None:
            torch.testing.assert_close(got.scores, want.scores, rtol=1e-4,
                                       atol=0)


@pytest.mark.parametrize("beam", [20, 40])
@pytest.mark.parametrize("mode", ["bf16", "unfused", "int8"])
def test_wide_beam_decode_matches_plain_decode(dev, beam, mode):
    """Beams past the fused kernels' lists of 16: the fused decodes'
    kernels write their logits and the top-k + logsumexp kernel takes
    them, each once a step (unfused: row 5 alone)."""
    cfg = Config(embed_size=64, latent_size=16, decoder_hidden=64,
                 gen_z_samples=4, prior="AG", use_c_v=True, gen_max_len=8,
                 beam_size=beam, std=0.0,
                 **{"bf16": {}, "unfused": dict(fused_decode=False),
                    "int8": dict(decode_int8=True)}[mode])
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(500)])
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    rng = np.random.default_rng(0)
    load_flax_params(model, {k: rng.normal(0, 0.3, size=s).astype(np.float32)
                             for k, s in flax_shapes(model).items()})
    model = model.to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn((16, 4096), generator=g, device=dev)
    c_v = (torch.rand((16, 90), generator=g, device=dev) < 0.05).float()
    kernel = make_decode_fns(model, cfg, vocab)["beam_search_all"]
    plain = make_decode_fns(model, cfg, vocab, ops=PLAIN_OPS)["beam_search_all"]
    _ext.reset_launches()
    got = kernel(feats, c_v)
    steps = got.steps
    counts = dict(_ext.LAUNCHES)
    want = plain(feats, c_v)
    assert counts["top_k_logsumexp"] == steps
    assert counts["fused_logits_top_k"] == (steps if mode == "bf16" else 0)
    assert counts["fused_logits_top_k_int8"] == (steps if mode == "int8" else 0)
    assert got.tokens.shape[1] == beam
    assert torch.equal(got.tokens, want.tokens)
    # int8 and unfused: see test_decode_modes_through_kernels_match_plain
    torch.testing.assert_close(got.scores, want.scores,
                               rtol=1e-4 if mode == "bf16" else 2e-3, atol=0)


def _vgg_npz(path: str) -> None:
    """VGG16 weights drawn by numpy in the Caffe npz layout (conv1_1_W ..
    fc8_b), He-normal, conv1_1 scaled to the pixels' range."""
    from vae_captioning_torch.models.vgg16 import CONV_BLOCKS

    rng = np.random.default_rng(0)
    arrays, width = {}, 3
    for name, out in (n for block in CONV_BLOCKS for n in block):
        std = (2.0 / (9 * width)) ** 0.5 / (128.0 if width == 3 else 1.0)
        arrays[f"{name}_W"] = np.float32(std) * rng.standard_normal(
            (3, 3, width, out), dtype=np.float32)
        arrays[f"{name}_b"] = np.zeros(out, np.float32)
        width = out
    for fc, shape in (("fc6", (25088, 4096)), ("fc7", (4096, 4096)),
                      ("fc8", (4096, 1000))):
        arrays[f"{fc}_W"] = np.float32((2.0 / shape[0]) ** 0.5) * (
            rng.standard_normal(shape, dtype=np.float32))
        arrays[f"{fc}_b"] = np.zeros(shape[1], np.float32)
    np.savez(path, **arrays)


def test_generator_on_the_card_matches_plain_ops(dev, tmp_path):
    """The single-image API on the card (VGG16 fc2 at batch 1, then the
    decode kernels) against the same Generator on the plain decode ops:
    greedy, beam 3 with every beam, with a cluster vector and without;
    sampling launches the sampler."""
    from vae_captioning_torch.checkpoint import save_params, save_sidecars
    from vae_captioning_torch.generate import Generator

    npz = str(tmp_path / "vgg16_weights.npz")
    _vgg_npz(npz)
    cfg = Config(embed_size=64, latent_size=16, decoder_hidden=64,
                 gen_z_samples=4, prior="AG", use_c_v=True, gen_max_len=8,
                 beam_size=3, image_net_weights_path=npz)
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(500)])
    cfg.vocab_size = vocab.vocab_size
    rng = np.random.default_rng(0)
    save_params({k: rng.normal(0, 0.3, size=s).astype(np.float32) for k, s in
                 flax_shapes(CVAEModel.from_config(cfg)).items()},
                str(tmp_path), "g")
    save_sidecars(cfg, vocab, str(tmp_path), "g")
    pixels = rng.integers(0, 256, (1, 224, 224, 3)).astype(np.float32)
    cv = (rng.random(90) < 0.05).astype(np.float32)
    for method, beam, beams in (("greedy", None, False),
                                ("beam_search", 3, True),
                                ("beam_search", 5, False)):
        kern = Generator(str(tmp_path), "g", method, device=dev)
        plain = Generator(str(tmp_path), "g", method, device=dev, ops=PLAIN_OPS)
        for vec in (None, cv):
            _ext.reset_launches()
            got = kern.caption_pixels(pixels, "x.jpg", beam, vec,
                                      return_beams=beams)
            assert _ext.LAUNCHES["fused_logits_top_k"] > 0
            assert got == plain.caption_pixels(pixels, "x.jpg", beam, vec,
                                               return_beams=beams)
    gen = Generator(str(tmp_path), "g", "sample", device=dev)
    _ext.reset_launches()
    out = gen.caption_pixels(pixels, "x.jpg")
    assert _ext.LAUNCHES["fused_logits_sample"] > 0
    assert isinstance(out[0]["caption"], str)
    assert gen.caption_pixels(pixels, "x.jpg") == out


# ----------------------------------------------------------------------
# the other decode modes' kernels: top-k + lse over logits, int8, sampling
# ----------------------------------------------------------------------

@pytest.mark.parametrize("N,V", [(1536, 11500), (13, 1000), (300, 11519)])
@pytest.mark.parametrize("k", [1, 3, 10, 16])
def test_top_k_logsumexp_kernel_matches_plain(dev, N, V, k):
    """Values are copied: values and indices bit for bit; lse to 1e-5."""
    g = torch.Generator(device=dev).manual_seed(N + k)
    x = torch.randn((N, V), generator=g, device=dev)
    x[::3, 7] = x[::3, 900] = x[::3].amax(dim=1) + 1.0     # planted ties
    before = _ext.LAUNCHES["top_k_logsumexp"]
    vals, idx, lse = top_k_logsumexp(x, k)
    p_vals, p_idx, p_lse = top_k_logsumexp_plain(x, k)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["top_k_logsumexp"] == before + 1
    assert torch.equal(idx, p_idx) and torch.equal(vals, p_vals)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)
    assert int(idx[0, 0]) == 7


def _planted_logits(dev, N, V, seed):
    """bf16-rounded normals (exact ties abound) with ties planted where the
    kernel's parts meet: the row maximum at columns 0 and 3-4 (a row's
    16-byte head; a lane's float4), 1023-1024 (a chunk of 256 float4) and
    V - 1 (the tail), a runner-up at 5, 1025 and 2047; in rows past 2200
    columns, -inf over columns 1-1100 of every third row and at every
    seventh column of the rows after them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, V), generator=g, device=dev).to(torch.bfloat16).float()
    top = x.amax(dim=1) + 1.0
    for c in (0, 3, 4, 1023, 1024, V - 1):
        if c < V:
            x[:, c] = top
    for c in (5, 1025, 2047):
        if c < V:
            x[:, c] = top - 0.5
    if V > 2200:
        x[::3, 1:1101] = float("-inf")
        x[1::3, ::7] = float("-inf")
    return x


@pytest.mark.parametrize("N,V,k", [
    (N, V, k) for N, V in ((1536, 11500), (10240, 11519), (13, 1000), (300, 40),
                           (7, 20000))
    for k in (17, 20, 32, 33, 40, 64, 65, 100, 256, 300) if k <= V])
def test_top_k_logsumexp_wide_lists_match_plain(dev, N, V, k):
    """Lists past 16 (k at run time: one entry a lane up to 32, then the
    select, a block a row: rows staged in shared memory, read from x at V =
    20000, the radix path past k = 128 and its global workspace past 512),
    planted ties and -inf: one launch, values and indices bit for bit, lse
    to 1e-5."""
    x = _planted_logits(dev, N, V, seed=N + V + k)
    before = _ext.LAUNCHES["top_k_logsumexp"]
    vals, idx, lse = top_k_logsumexp(x, k)
    p_vals, p_idx, p_lse = top_k_logsumexp_plain(x, k)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["top_k_logsumexp"] == before + 1
    assert torch.equal(idx, p_idx) and torch.equal(vals, p_vals)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)


def _adversarial_rows(dev, kind, N, V, k, seed):
    """Rows that defeat the select's bound or a digit: every value equal;
    k - 3 values above 0, then eight zeros, every other one -0.0, on the
    k-th place and around it, the rest below 0; exactly k finite values,
    the rest -inf; bf16-rounded normals (k = V)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "equal":
        return torch.full((N, V), 0.5, device=dev)
    if kind == "k = V":
        return torch.randn((N, V), generator=g, device=dev).to(torch.bfloat16).float()
    cols = torch.rand((N, V), generator=g, device=dev).argsort(dim=1)
    if kind == "k finite":
        x = torch.full((N, V), float("-inf"), device=dev)
        return x.scatter_(1, cols[:, :k], torch.randn((N, k), generator=g, device=dev))
    x = -1.0 - torch.rand((N, V), generator=g, device=dev)
    x.scatter_(1, cols[:, :k - 3], 1.0 + torch.rand((N, k - 3), generator=g, device=dev))
    zeros = torch.zeros((N, 8), device=dev)
    zeros[:, ::2] = -0.0
    return x.scatter_(1, cols[:, k - 3:k + 5], zeros)


@pytest.mark.parametrize("kind,N,V,k", [
    (kind, N, V, k) for kind in ("equal", "signed zeros", "k finite")
    for N, V, k in ((300, 11519, 40), (64, 11519, 100), (9, 1000, 33), (5, 20000, 65))]
    + [("k = V", 13, 1000, 1000), ("k = V", 3, 11519, 11519)])
def test_top_k_logsumexp_select_adversarial_rows_match_plain(dev, kind, N, V, k):
    """The select on rows made to defeat it: every value equal (the bound
    takes every column; the radix path's ties by column), -0.0 and +0.0
    mixed at the k-th place (one key; the values' sign bits copied),
    exactly k finite values, and k = V (the winners past 512 in the
    workspace): one launch, values (sign bits too) and indices bit for bit,
    lse to 1e-5."""
    x = _adversarial_rows(dev, kind, N, V, k, seed=N + V + k)
    before = _ext.LAUNCHES["top_k_logsumexp"]
    vals, idx, lse = top_k_logsumexp(x, k)
    p_vals, p_idx, p_lse = top_k_logsumexp_plain(x, k)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["top_k_logsumexp"] == before + 1
    assert torch.equal(vals.view(torch.int32), p_vals.view(torch.int32))
    assert torch.equal(idx, p_idx)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)


@pytest.mark.parametrize("M,H,V,int8,rows", [
    (10240, 512, 11500, False, 0), (700, 512, 11519, True, 0),
    (10240, 512, 11519, False, 0), (10240, 512, 11519, True, 0),
    (65, 1024, 11519, False, 0), (65, 2048, 11500, False, 0),
    (300, 96, 11519, False, 0), (512, 512, 11519, False, 64),
    (65, 2624, 11519, True, 0), (1, 512, 130, True, 0)])
def test_logits_writer_geometries_match_plain(dev, M, H, V, int8, rows):
    """The fused logits kernels' writer (beams past K_MAX) at every block
    shape, also at full width with V % 4 != 0 (rows padded to 16 bytes,
    the [M, V] view handed over): int8 bit for bit ``int8_logits``; bf16
    bit for bit the fused top-k's own values at its top-10 (the same
    accumulators), and within the f32 error bound of a length-H dot
    product in any order of the exact logits: gamma_H |h| |w| + u |logit|,
    u = 2^-24."""
    h, w_t, b = _logits_args(dev, M, H, V, seed=M + H)
    plan = logits_plan(M, H, V, 1, 1 if int8 else 2, rows=rows)
    if int8:
        hq, hs = quantize_rows(h.float())
        wq, ws = quantize_logits_weights(w_t.t().float())
        got = int8_logits_kernel(hq, hs, wq, ws, b, plan)
        assert got.stride() == (logits_pitch(V), 1)
        assert torch.equal(got, int8_logits(hq, hs, wq, ws, b))
    else:
        got = logits_kernel(h, w_t, b, plan)
        assert got.stride() == (logits_pitch(V), 1)
        k = min(10, V)
        vals, idx, _ = logits_top_k_kernel(h, w_t, b, k, logits_plan(M, H, V, k, 2, rows=rows))
        assert torch.equal(got.gather(1, idx.long()), vals)
        u = 2.0 ** -24
        hd, wd = h.double(), w_t.t().double()
        exact = hd @ wd + b.double()
        tol = H * u / (1 - H * u) * (hd.abs() @ wd.abs()) + u * exact.abs()
        assert bool(((got.double() - exact).abs() <= tol).all())


@pytest.mark.parametrize("k", [17, 20, 32])
def test_wide_logits_top_k_routes_through_written_logits(dev, k):
    """The bf16 and int8 top-k past K_MAX: their kernels write the logits
    (one launch each), then the top-k + logsumexp kernel; bf16 to the
    fused top-k's bar, int8 bit for bit."""
    g = torch.Generator(device=dev).manual_seed(k)
    h = torch.randn((700, 512), generator=g, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn((512, 11500), generator=g, device=dev)
         ).to(torch.bfloat16).t().contiguous().t()
    b = 0.1 * torch.randn((11500,), generator=g, device=dev)
    wq, ws = quantize_logits_weights(w.float())
    _ext.reset_launches()
    got = fused_logits_top_k(h, w, b, k)
    got8 = fused_logits_top_k_int8(h, wq, ws, b, k)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["top_k_logsumexp"] == 2
    assert _ext.LAUNCHES["fused_logits_top_k"] == 1
    assert _ext.LAUNCHES["fused_logits_top_k_int8"] == 1
    _assert_top_k(got, fused_logits_top_k_plain(h, w, b, k + 1), k)
    v, i, l = got8
    pv, pi, pl = fused_logits_top_k_int8_plain(h, wq, ws, b, k)
    assert torch.equal(i, pi) and torch.equal(v, pv)
    torch.testing.assert_close(l, pl, rtol=1e-5, atol=0)


@pytest.mark.parametrize("N", [300, 1536])
@pytest.mark.parametrize("k", [20, 40, 65])
def test_top_k_logsumexp_on_pitched_rows_matches_contiguous(dev, N, k):
    """Row 5 on the writer's layout, rows logits_pitch(V) floats apart (V =
    11519: the pitch 11520, the pad columns NaN, never read), against the
    same kernel on the contiguous copy (one list a lane, and the select past
    32): values and indices bit for bit, and equal to the plain
    version's; the logsumexp to 1e-5, since a lane's share of a row, and
    so the sum's order, follows where the row meets a 16-byte boundary."""
    V = 11519
    buf = torch.full((N, logits_pitch(V)), float("nan"), device=dev)
    x = buf[:, :V]
    x.copy_(_planted_logits(dev, N, V, seed=N + k))
    got = top_k_logsumexp(x, k)
    want = top_k_logsumexp(x.contiguous(), k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    p_vals, p_idx, _ = top_k_logsumexp_plain(x.contiguous(), k)
    assert torch.equal(got[0], p_vals) and torch.equal(got[1], p_idx)


@pytest.mark.parametrize("int8", [False, True])
def test_wide_top_k_at_a_ragged_vocab_launches_the_writer_and_row_5_once(dev, int8):
    """Past K_MAX at V % 4 != 0 (11,519): the wrapper launches the writer
    once (into rows of logits_pitch(V) floats) and the top-k + logsumexp
    once over the view; bf16 to the fused top-k's bar, int8 bit for bit."""
    g = torch.Generator(device=dev).manual_seed(7 + int8)
    V, k = 11519, 20
    h = torch.randn((700, 512), generator=g, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn((512, V), generator=g, device=dev)
         ).to(torch.bfloat16).t().contiguous().t()
    b = 0.1 * torch.randn((V,), generator=g, device=dev)
    name = "fused_logits_top_k_int8" if int8 else "fused_logits_top_k"
    _ext.reset_launches()
    if int8:
        wq, ws = quantize_logits_weights(w.float())
        got = fused_logits_top_k_int8(h, wq, ws, b, k)
    else:
        got = fused_logits_top_k(h, w, b, k)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES[name] == 1 and _ext.LAUNCHES["top_k_logsumexp"] == 1
    assert sum(_ext.LAUNCHES.values()) == 2
    if int8:
        pv, pi, pl = fused_logits_top_k_int8_plain(h, wq, ws, b, k)
        assert torch.equal(got[1], pi) and torch.equal(got[0], pv)
        torch.testing.assert_close(got[2], pl, rtol=1e-5, atol=0)
    else:
        _assert_top_k(got, fused_logits_top_k_plain(h, w, b, k + 1), k)


@pytest.mark.parametrize("N,V,k", [(N, V, k) for N in (1, 13, 1536, 5120)
                                   for V in (11500, 11519, 1000, 3)
                                   for k in (1, 3, 10, 16) if k <= V])
def test_top_k_logsumexp_kernel_geometries_match_plain(dev, N, V, k):
    """Rows past the persistent grid's warps (5120), misaligned rows (V =
    11519: a row starts off a 16-byte boundary), rows shorter than a
    float4 (V = 3), planted ties and -inf: values and indices bit for bit,
    lse to 1e-5."""
    x = _planted_logits(dev, N, V, seed=N + V + k)
    vals, idx, lse = top_k_logsumexp(x, k)
    p_vals, p_idx, p_lse = top_k_logsumexp_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(idx, p_idx) and torch.equal(vals, p_vals)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)


@pytest.mark.parametrize("M,H,V", [(1536, 512, 11500), (1000, 512, 11519),
                                   (70, 64, 4001)])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_int8_kernel_matches_plain(dev, M, H, V, k):
    """The int32 product is exact and the dequantisation rounds each step
    on its own on both sides: values and indices bit for bit."""
    g = torch.Generator(device=dev).manual_seed(M + V + k)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev))
    wq, ws = quantize_logits_weights(
        0.05 * torch.randn((H, V), generator=g, device=dev))
    b = 0.1 * torch.randn((V,), generator=g, device=dev)
    before = _ext.LAUNCHES["fused_logits_top_k_int8"]
    vals, idx, lse = fused_logits_top_k_int8(h, wq, ws, b, k)
    p_vals, p_idx, p_lse = fused_logits_top_k_int8_plain(h, wq, ws, b, k)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["fused_logits_top_k_int8"] == before + 1
    assert torch.equal(idx, p_idx) and torch.equal(vals, p_vals)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)


@pytest.mark.parametrize("M,H,V", [(512, 512, 11500), (1000, 512, 11519),
                                   (33, 64, 130)])
def test_sample_kernel_matches_plain(dev, M, H, V):
    """Same Philox bits on both sides; logf on the card and torch.log may
    differ by an ulp and the logits by sum order, so rows whose top two
    scored values lie within 1e-4 may differ; every other row agrees."""
    g = torch.Generator(device=dev).manual_seed(M)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev)).to(torch.bfloat16)
    w = (0.05 * torch.randn((H, V), generator=g, device=dev)).to(torch.bfloat16)
    b = 0.1 * torch.randn((V,), generator=g, device=dev)
    before = _ext.LAUNCHES["fused_logits_sample"]
    got = fused_logits_sample(h, w, b, 1234, 5, 0.8)
    scores = sample_scores(h, w, b, 1234, 5, 0.8)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["fused_logits_sample"] == before + 1
    top2 = scores.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert got.dtype == torch.int32
    assert torch.equal(got[clear], scores.argmax(dim=1).int()[clear])
    assert float(clear.float().mean()) > 0.95


def test_sample_kernel_law(dev):
    """200,000 draws from one row at V = 100: TV below 0.02 of
    softmax(logits / T) at three temperatures."""
    g = torch.Generator(device=dev).manual_seed(0)
    H, V, draws = 64, 100, 200_000
    h = torch.randn((1, H), generator=g, device=dev).to(torch.bfloat16)
    w = (0.3 * torch.randn((H, V), generator=g, device=dev)).to(torch.bfloat16)
    b = 0.5 * torch.randn((V,), generator=g, device=dev)
    logits = fused_logits_top_k_plain(h, w, b, V)
    full = torch.empty(V, device=dev).scatter_(0, logits[1][0].long(),
                                               logits[0][0])
    for t in (0.7, 1.0, 1.5):
        tokens = fused_logits_sample(h.expand(draws, H).contiguous(), w, b,
                                     99, 3, t)
        freq = torch.bincount(tokens.long(), minlength=V).double() / draws
        p = torch.softmax(full.double() / t, dim=0)
        assert float(0.5 * (freq - p).abs().sum()) < 0.02, t


def _small_model(dev):
    cfg = Config(embed_size=64, latent_size=16, decoder_hidden=64,
                 gen_z_samples=4, prior="AG", use_c_v=True, gen_max_len=8,
                 beam_size=3, std=0.0)
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(500)])
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    rng = np.random.default_rng(0)
    load_flax_params(model, {k: rng.normal(0, 0.3, size=s).astype(np.float32)
                             for k, s in flax_shapes(model).items()})
    return cfg, vocab, model.to(dev)


@pytest.mark.parametrize("mode", ["int8", "unfused", "sample"])
def test_decode_modes_through_kernels_match_plain(dev, mode):
    """The int8 and unfused decodes token for token; the sampled decode
    launches the sampler once per step and agrees with the plain sampler
    in most captions (near-ties may go either way)."""
    cfg, vocab, model = _small_model(dev)
    cfg = cfg.replace(**{"int8": dict(decode_int8=True),
                         "unfused": dict(fused_decode=False),
                         "sample": dict(sample_gen="sample")}[mode])
    feats = torch.randn((16, 4096), device=dev)
    c_v = (torch.rand((16, 90), device=dev) < 0.05).float()
    kernel = make_decode_fns(model, cfg, vocab)
    plain = make_decode_fns(model, cfg, vocab, ops=PLAIN_OPS)
    names = ("sample",) if mode == "sample" else ("beam_search", "greedy")
    for name in names:
        _ext.reset_launches()
        gen = lambda: torch.Generator(device=dev).manual_seed(4)  # noqa: E731
        got = kernel[name](feats, c_v, generator=gen())
        want = plain[name](feats, c_v, generator=gen())
        counts = dict(_ext.LAUNCHES)
        if mode == "sample":
            assert counts["fused_logits_sample"] == got.steps
            same = (got.tokens == want.tokens).all(dim=1).float().mean()
            assert float(same) >= 0.75
            continue
        assert torch.equal(got.tokens, want.tokens), name
        if got.scores is not None:
            # the LSTM kernel's sum order can move an element of h across
            # a rounding boundary of its int8 quantisation, or of the bf16
            # logits the unfused step writes, which moves a logit by one
            # step of that rounding (2e-4 and 5e-4 of a score seen)
            torch.testing.assert_close(got.scores, want.scores, rtol=2e-3,
                                       atol=0)
        assert counts["fused_logits_top_k"] == 0
        if mode == "int8":
            assert counts["fused_logits_top_k_int8"] == got.steps
        elif name == "beam_search":
            assert counts["top_k_logsumexp"] == got.steps


def test_new_wrappers_check_their_inputs(dev):
    h = torch.zeros((4, 96), device=dev)
    wq = torch.zeros((64, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="disagree"):
        fused_logits_top_k_int8(h, wq, torch.ones(64, device=dev),
                                torch.zeros(64, device=dev), 3)
    with pytest.raises(ValueError, match="float32"):
        top_k_logsumexp(torch.zeros((4, 64), device=dev, dtype=torch.bfloat16), 3)
    with pytest.raises(ValueError, match="temperature"):
        fused_logits_sample(h[:, :64].to(torch.bfloat16).contiguous(),
                            torch.zeros((64, 64), device=dev,
                                        dtype=torch.bfloat16),
                            torch.zeros(64, device=dev), 0, 0, 0.0)


# ----------------------------------------------------------------------
# train-path kernels
# ----------------------------------------------------------------------

def _seq_args(dev, T, N, E, H, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    lim = (6.0 / (E + H + 4 * H)) ** 0.5
    w = (torch.rand((E + H, 4 * H), generator=g, device=dev) * 2 - 1) * lim
    lengths = torch.randint(1, T + 1, (N,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 1, T
    return [torch.randn((T, N, E), generator=g, device=dev),
            w[:E].clone(), w[E:].clone(),
            0.1 * torch.randn((4 * H,), generator=g, device=dev),
            torch.randn((N, H), generator=g, device=dev),
            torch.tanh(torch.randn((N, H), generator=g, device=dev)), lengths]


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


@pytest.mark.parametrize("T,N,E,H", [(3, 70, 64, 64), (7, 1000, 256, 512),
                                     (24, 1280, 256, 512), (24, 1, 256, 512),
                                     (24, 65, 256, 512), (1, 1280, 256, 512),
                                     (5, 600, 256, 1024), (5, 70, 40, 48),
                                     (6, 300, 300, 500)])
def test_lstm_seq_kernels_match_plain(dev, T, N, E, H):
    """Forward and backward.  f32 sums in another order can flip an
    element of bf16(h), which moves later steps by ~1e-3, and the flips
    compound over T (at T = 24, 0.993 of the elements of c_T agreed to
    1e-4 on an H100); so c_T, h_T and hs to 1e-2 of their max and 99% of
    elements to 1e-4, gradients to 1e-2 of each one's max."""
    args = _seq_args(dev, T, N, E, H, seed=T + N)
    leaves = [[a.clone().requires_grad_() for a in args[:6]] for _ in range(2)]
    g = torch.Generator(device=dev).manual_seed(1)
    w_hs = torch.randn((T, N, H), generator=g, device=dev)
    w_c = torch.randn((N, H), generator=g, device=dev)
    before = dict(_ext.LAUNCHES)
    outs = []
    for fn, lv in zip((fused_lstm_seq, fused_lstm_seq_plain), leaves):
        (ct, ht), hs = fn(*lv, args[6])
        ((hs.float() * w_hs).sum() + (ct * w_c).sum() + ht.sum()).backward()
        outs.append((ct, ht, hs))
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["fused_lstm_seq_fwd"] == before["fused_lstm_seq_fwd"] + 1
    assert _ext.LAUNCHES["fused_lstm_seq_bwd"] == before["fused_lstm_seq_bwd"] + 1
    for a, b in zip(outs[0], outs[1]):
        assert _rel(a, b) < 1e-2
        close = (a.detach().float() - b.detach().float()).abs() <= 1e-4
        assert float(close.float().mean()) > 0.99
    # rows of length 1 (row 0, unless N = 1 makes it the length-T row)
    assert not outs[0][2][:, args[6] == 1][1:].float().abs().any()
    for k, (a, b) in enumerate(zip(leaves[0], leaves[1])):
        assert _rel(a.grad, b.grad) < 1e-2, k


@pytest.mark.parametrize("N,K,L,E", [(70, 3, 150, 64), (1000, 100, 150, 256),
                                     (1, 100, 150, 256), (65, 7, 37, 128),
                                     (300, 5, 150, 512), (70, 3, 150, 40),
                                     (300, 5, 150, 300)])
def test_fused_z_kernels_match_plain(dev, N, K, L, E):
    g = torch.Generator(device=dev).manual_seed(N)
    mean = torch.randn((N, L), generator=g, device=dev)
    std = torch.rand((N, L), generator=g, device=dev) + 0.3
    w = 0.05 * torch.randn((E, K * L), generator=g, device=dev)
    b = torch.randn((E,), generator=g, device=dev)
    cot = torch.randn((N, E), generator=g, device=dev)
    leaves = [[t.clone().requires_grad_() for t in (mean, std, w, b)]
              for _ in range(2)]
    outs = []
    for fn, lv in zip((fused_z, fused_z_plain), leaves):
        out = fn(*lv, K, 77, 5)
        (out.float() * cot).sum().backward()
        outs.append(out)
    torch.cuda.synchronize()
    assert outs[0].dtype == torch.bfloat16
    # bf16 outputs: within one bf16 step of the f32 sum's rounding
    assert _rel(outs[0], outs[1]) < 1e-2
    for k, (a, c) in enumerate(zip(leaves[0], leaves[1])):
        assert _rel(a.grad, c.grad) < 1e-3, k


@pytest.mark.parametrize("N,K,L,E", [(1280, 100, 150, 256), (65, 7, 37, 128),
                                     (300, 5, 150, 512)])
def test_fused_z_kernels_repeat_bit_for_bit(dev, N, K, L, E):
    """Both kernels give the same bits on a second call: no float
    atomics, every split summed in a fixed order."""
    g = torch.Generator(device=dev).manual_seed(N + K)
    mean = torch.randn((N, L), generator=g, device=dev)
    std = torch.rand((N, L), generator=g, device=dev) + 0.3
    w = (0.05 * torch.randn((E, K * L), generator=g, device=dev)).to(torch.bfloat16)
    b = torch.randn((E,), generator=g, device=dev)
    dz = torch.randn((N, E), generator=g, device=dev).to(torch.bfloat16)
    outs = [z_fwd_kernel(mean, std, w, b, K, 11, 3) for _ in range(2)]
    grads = [z_bwd_kernel(mean, std, w, K, 11, 3, dz) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_fused_z_eps_bits_equal_the_plain_generator(dev):
    bits = fused_z_eps(123, 9, 300, 7, 150, device=dev, bits=True)
    assert torch.equal(bits, philox_bits(123, 9, 300, 7, 150, device=dev))
    eps = fused_z_eps(123, 9, 300, 7, 150, device=dev)
    assert float((eps - philox_normals(123, 9, 300, 7, 150, device=dev)
                  ).abs().max()) <= 1e-6
    # the plain generator's integer ops give the same bits on the CPU
    assert torch.equal(bits.cpu(), philox_bits(123, 9, 300, 7, 150))


@pytest.mark.parametrize("N,K,L", [(1280, 100, 150), (1281, 7, 150), (21001, 101, 3),
                                   (4001, 333, 5), (3001, 441, 8), (7, 3, 5)])
@pytest.mark.parametrize("bits", [False, True])
def test_fused_z_eps_matches_the_plain_generator(dev, N, K, L, bits):
    """Rows of 150, 3, 5 and 8 floats, N K not a multiple of 4 rows or of
    a block's span, blocks that stage more than one span: the words equal
    ``philox_bits``, the normals ``philox_normals``, bit for bit."""
    got = fused_z_eps(77, 5, N, K, L, device=dev, bits=bits)
    want = (philox_bits if bits else philox_normals)(77, 5, N, K, L, device=dev)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_train_wrappers_check_their_inputs(dev):
    args = _seq_args(dev, 3, 8, 32, 64)
    with pytest.raises(ValueError, match="int32"):
        fused_lstm_seq(*args[:6], args[6].long())
    x, c, h, w, b = _lstm_args(dev, 8, 32, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm_step(x, c, h, w.float().requires_grad_(), b)
    with pytest.raises(ValueError, match="disagree"):
        fused_z(torch.zeros(4, 10, device=dev), torch.ones(4, 10, device=dev),
                torch.zeros(32, 30, device=dev), torch.zeros(32, device=dev),
                2, 0, 0)


@pytest.mark.parametrize("N,H,K,L", [(70, 64, 7, 37), (1000, 512, 12, 150),
                                     (1280, 512, 90, 150), (1, 512, 90, 150),
                                     (65, 512, 90, 150), (1000, 128, 12, 150),
                                     (300, 768, 12, 150), (70, 768, 7, 37),
                                     (70, 1024, 7, 37), (130, 256, 7, 150),
                                     (70, 64, 5, 37), (65, 64, 200, 3),
                                     (70, 48, 7, 37), (300, 500, 12, 150)])
def test_ag_heads_kernels_match_plain(dev, N, H, K, L):
    """Forward to 1e-4 of the largest element (f32 sums in another order);
    db to 1e-4 (both from f32 dq); dh, dW and dc_v to 8e-3, two bf16 steps
    (the kernels round dq to bf16 for the tensor cores, the plain version
    rounds the gradients themselves to bf16, as the reference's casts do;
    3e-3 to 4.7e-3 measured on an H100)."""
    g = torch.Generator(device=dev).manual_seed(N + K)
    h = torch.randn((N, H), generator=g, device=dev)
    w = 0.05 * torch.randn((2 * K * L, H), generator=g, device=dev)
    b = 0.1 * torch.randn((2 * K * L,), generator=g, device=dev)
    c_v = torch.rand((N, K), generator=g, device=dev)
    c_v[::7] = 0.0                               # images with no detection
    c_v = c_v / c_v.sum(dim=1, keepdim=True).clamp_min(1e-9)
    cots = [torch.randn((N, L), generator=g, device=dev) for _ in range(2)]
    leaves = [[t.clone().requires_grad_() for t in (h, w, b, c_v)]
              for _ in range(2)]
    before = dict(_ext.LAUNCHES)
    outs = []
    for fn, lv in zip((fused_ag_heads, ag_heads_plain), leaves):
        m, s = fn(*lv)
        ((m * cots[0]).sum() + (s * cots[1]).sum()).backward()
        outs.append((m, s))
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["fused_ag_heads_fwd"] == before["fused_ag_heads_fwd"] + 1
    assert _ext.LAUNCHES["fused_ag_heads_bwd"] == before["fused_ag_heads_bwd"] + 1
    for a, r in zip(*outs):
        assert a.dtype == torch.float32 and a.shape == (N, L)
        assert _rel(a, r) < 1e-4
    assert not outs[0][0][::7].any() and not outs[0][1][::7].any()
    for name, a, r, tol in zip(("dh", "dw", "db", "dcv"), leaves[0],
                               leaves[1], (8e-3, 8e-3, 1e-4, 8e-3)):
        assert _rel(a.grad, r.grad) < tol, name


@pytest.mark.parametrize("kernel", ["ag_heads", "flash_ce", "written_logits_ce"])
@pytest.mark.parametrize("big", [True, False], ids=["train", "ragged"])
def test_forward_kernels_repeat_bit_for_bit(dev, kernel, big):
    """The AG-heads forward (q_mean, q_std) and the CE forward of both
    schedules (lse, ll, and the written logits) give identical outputs in
    two calls on the same inputs: no float atomics, and the groups' and
    vocab chunks' partials are merged in order."""
    g = torch.Generator(device=dev).manual_seed(11)
    if kernel == "ag_heads":
        N, H, K, L = (1280, 512, 90, 150) if big else (65, 128, 7, 37)
        ops = ag_prepare(torch.randn((N, H), generator=g, device=dev),
                         0.05 * torch.randn((2 * K * L, H), generator=g, device=dev),
                         0.1 * torch.randn((2 * K * L,), generator=g, device=dev),
                         torch.rand((N, K), generator=g, device=dev))
        fn = ag_heads_fwd_kernel
    else:
        M, H, V = (30720, 512, 11500) if big else (77, 128, 301)
        ops = prepare(torch.tanh(torch.randn((M, H), generator=g, device=dev)),
                      0.05 * torch.randn((V, H), generator=g, device=dev),
                      0.1 * torch.randn((V,), generator=g, device=dev),
                      torch.randint(0, V, (M,), generator=g, device=dev))
        fn = fused_ce_fwd_kernel if kernel == "flash_ce" else ce_mat_fwd_kernel
    first, second = fn(*ops), fn(*ops)
    torch.cuda.synchronize()
    for a, r in zip(first, second):
        assert torch.equal(a, r)
        assert bool(torch.isfinite(a.float()).any())


@pytest.mark.parametrize("N,H,K,L", [(1280, 512, 90, 150), (65, 128, 7, 37),
                                     (300, 768, 12, 37)],
                         ids=["train", "ragged", "wide"])
def test_ag_heads_backward_repeats_bit_for_bit(dev, N, H, K, L):
    """The AG-heads backward gives identical dh, dW, db and dc_v in two
    calls: no float atomics, and the db, dc_v and dh-split partials are
    summed in order."""
    g = torch.Generator(device=dev).manual_seed(12)
    ops = ag_prepare(torch.randn((N, H), generator=g, device=dev),
                     0.05 * torch.randn((2 * K * L, H), generator=g, device=dev),
                     0.1 * torch.randn((2 * K * L,), generator=g, device=dev),
                     torch.rand((N, K), generator=g, device=dev))
    cots = [torch.randn((N, L), generator=g, device=dev) for _ in range(2)]
    first = ag_heads_bwd_kernel(*ops, *cots)
    second = ag_heads_bwd_kernel(*ops, *cots)
    torch.cuda.synchronize()
    for name, a, r in zip(("dh", "dw", "db", "dcv"), first, second):
        assert torch.equal(a, r), name
        assert bool(torch.isfinite(a).all()), name


def test_ag_heads_wrapper_checks_its_inputs(dev):
    h = torch.zeros((4, 96), device=dev)
    with pytest.raises(ValueError, match="disagree"):
        fused_ag_heads(h, torch.zeros((2 * 3 * 5, 64), device=dev),
                       torch.zeros(30, device=dev), torch.zeros((4, 3), device=dev))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused_ag_heads(h[:, :64].cpu(), torch.zeros((30, 64), device=dev),
                       torch.zeros(30, device=dev), torch.zeros((4, 3), device=dev))


@pytest.mark.parametrize("M,H,V", [(300, 64, 2000), (1000, 512, 11519),
                                   (77, 128, 301), (1, 512, 11500),
                                   (65, 512, 11500), (30720, 512, 11500),
                                   (1000, 256, 11519), (100, 64, 37),
                                   (300, 64, 1921), (77, 128, 130),
                                   (300, 48, 2000), (77, 500, 301),
                                   (300, 576, 2000), (77, 1000, 301),
                                   (1000, 1024, 11519), (65, 2048, 11500)])
def test_linear_ce_kernels_match_plain(dev, M, H, V):
    """The three flash CE kernels against the plain version's VJP, about
    40% of the rows PAD (weight 0; label 0, or on every other PAD row a
    label past V), row 0 live: the loss, lse and ll to 1e-5 (f32 sums in
    another order); db to 1e-4 of its largest element (from the f32 dl on
    both sides); dh and dW to 1e-3 (an element of dl whose two f32 values
    straddle a bf16 rounding boundary moves its product by one bf16
    step); rows of weight 0 get dh = 0 exactly.  The shapes cover the
    backward's 64-row tiles: one row, one row past a tile, the train
    shapes, every width, and a vocabulary smaller than a tile."""
    g = torch.Generator(device=dev).manual_seed(M + V)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev))
    w = 0.05 * torch.randn((V, H), generator=g, device=dev)
    b = 0.1 * torch.randn((V,), generator=g, device=dev)
    labels = torch.randint(1, V, (M,), generator=g, device=dev)
    mask = (torch.rand((M,), generator=g, device=dev) > 0.4).float()
    mask[0] = 1.0
    labels[mask == 0] = 0
    labels[torch.nonzero(mask == 0)[1::2, 0]] = V + 7
    weights = mask / mask.sum()
    leaves = [[t.clone().requires_grad_() for t in (h, w, b)] for _ in range(2)]
    before = dict(_ext.LAUNCHES)
    lib = _ext.library()
    clustered = lib.vct_fused_ce_bwd_cluster_launches()
    fwd_clustered = lib.vct_fused_ce_fwd_cluster_launches()
    losses = []
    for fn, lv in zip((fused_linear_ce, fused_linear_ce_plain), leaves):
        loss = fn(*lv, labels, weights)
        loss.backward()
        losses.append(float(loss.detach()))
    # the backward at 1024 (1000 pads to it) ran the cluster instance, dh
    # and dW/db once each; the other widths never do, by the same rule in C
    Hp = ce_width(H)
    assert lib.vct_fused_ce_bwd_cluster(Hp) == bwd_cluster(Hp)
    assert (lib.vct_fused_ce_bwd_cluster_launches() - clustered
            == (2 if Hp == 1024 else 0))
    lse, ll = fused_ce_fwd_kernel(*prepare(*pad_ce(h, w), b, labels))
    # the forward past 512 at resident widths (576, 1024 here) ran in
    # clusters, in the loss and in the call above, by the same rule in C
    assert lib.vct_fused_ce_fwd_cluster(Hp, 0) == fwd_cluster(Hp)
    assert (lib.vct_fused_ce_fwd_cluster_launches() - fwd_clustered
            == (2 if Hp in (576, 1024) else 0))
    p_lse, p_ll = ce_fwd_plain(h, w, b, labels)
    torch.cuda.synchronize()
    for name in ("fwd", "dh", "dwdb"):
        key = f"fused_linear_ce_{name}"
        assert _ext.LAUNCHES[key] == before[key] + (2 if name == "fwd" else 1)
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)
    assert _rel(ll, p_ll) < 1e-5
    for name, a, r, tol in zip(("dh", "dw", "db"), leaves[0], leaves[1],
                               (1e-3, 1e-3, 1e-4)):
        assert a.grad.dtype == torch.float32 and bool(torch.isfinite(a.grad).all())
        assert _rel(a.grad, r.grad) < tol, name
    assert not leaves[0][0].grad[mask == 0].any()


@pytest.mark.parametrize("schedule", ["flash", "written_logits"])
@pytest.mark.parametrize("M,H,V", [(30720, 512, 11500), (3000, 128, 2001),
                                   (3000, 1024, 2001)])
def test_linear_ce_backward_repeats_bit_for_bit(dev, schedule, M, H, V):
    """dh, dW and db of two calls on the same inputs are identical, for the
    flash CE's backward kernels and for the written logits' (the hybrid
    and XLA-forward schedules): no float atomics, and dW/db's row splits
    (5 at the train shapes) are summed in split order."""
    g = torch.Generator(device=dev).manual_seed(7)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev))
    w = 0.05 * torch.randn((V, H), generator=g, device=dev)
    b = 0.1 * torch.randn((V,), generator=g, device=dev)
    labels = torch.randint(0, V, (M,), generator=g, device=dev)
    weights = torch.rand((M,), generator=g, device=dev) / M
    ops = prepare(h, w, b, labels)
    assert ce_bwd_plan(M, H, V).splits > 1
    clustered = _ext.library().vct_fused_ce_bwd_cluster_launches()
    if schedule == "flash":
        lse, _ = fused_ce_fwd_kernel(*ops)

        def backward():
            return (fused_ce_dh_kernel(*ops, lse, weights),
                    *fused_ce_dwdb_kernel(*ops, lse, weights))
    else:
        lg, lse, _ = ce_mat_fwd_kernel(*ops)

        def backward():
            return (ce_mat_dh_kernel(lg, ops[1], ops[3], lse, weights),
                    *ce_mat_dwdb_kernel(ops[0], lg, ops[3], lse, weights, V))
    first, second = backward(), backward()
    torch.cuda.synchronize()
    # at 1024 the flash backward is the cluster instance (two calls of dh
    # and dW/db); the written logits' kernels never are
    assert (_ext.library().vct_fused_ce_bwd_cluster_launches() - clustered
            == (4 if schedule == "flash" and H == 1024 else 0))
    assert fwd_cluster(H, schedule == "written_logits") == (2 if H == 1024 else 0)
    for name, a, r in zip(("dh", "dW", "db"), first, second):
        assert torch.equal(a, r), name
        assert bool(a.abs().max() > 0), name


def test_linear_ce_wrapper_checks_its_inputs(dev):
    h = torch.zeros((4, 4160), device=dev)    # past CE_H_MAX
    lab = torch.zeros(4, dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="up to 4096"):
        fused_linear_ce(h, torch.zeros((30, 4160), device=dev),
                        torch.zeros(30, device=dev), lab, torch.ones(4, device=dev))
    with pytest.raises(ValueError, match="weights"):
        fused_linear_ce(h[:, :64], torch.zeros((30, 64), device=dev),
                        torch.zeros(30, device=dev), lab, torch.ones(5, device=dev))


@pytest.mark.parametrize("written_logits", [False, True])
def test_ce_forward_block_shapes(dev, written_logits):
    """The CE forward's blocks as csrc/fused_ce.cuh's fwd_block chooses
    them: 128 rows resident at the compile-time widths; past 512 64 rows,
    resident where they fit beside a ring of four W boxes (H <= 1280; with
    the written logits' two staged boxes H <= 1152), else streamed."""
    last = 1152 if written_logits else 1280
    for H in (64, 128, 256, 512):
        assert fwd_block(H, written_logits) == (128, True)
    for H in (576, 1024, 1152, 1216, 1280, 1344, 2048, 4096):
        assert fwd_block(H, written_logits) == (64, H <= last), H
    with pytest.raises(ValueError, match="up to 4096"):
        fwd_block(4160, written_logits)
    # the forward's clusters: the C shape rule is ops/fused_ce.py's at
    # every width the kernels take, and takes the resident 64-row blocks
    # (the wide cell's 1024 among them)
    lib = _ext.library()
    for H in range(64, 4097, 64):
        assert lib.vct_fused_ce_fwd_cluster(H, int(written_logits)) == fwd_cluster(
            H, written_logits), H
    assert fwd_cluster(1024, written_logits) == 2
    assert [H for H in range(576, 4097, 64) if fwd_cluster(H, written_logits)] == list(
        range(576, last + 1, 64))


@pytest.mark.parametrize("schedule", ["hybrid", "xla_bwd"])
@pytest.mark.parametrize("M,H,V", [(300, 64, 2000), (1000, 512, 11519),
                                   (77, 128, 301), (1, 512, 11500),
                                   (65, 512, 11500), (30720, 512, 11500),
                                   (1000, 256, 11519), (100, 64, 37),
                                   (300, 64, 1921), (77, 128, 130),
                                   (300, 48, 2000), (77, 500, 301),
                                   (300, 576, 2000), (77, 1000, 301),
                                   (1000, 1024, 11519), (65, 2048, 11500)])
def test_written_logits_ce_kernels_match_plain(dev, schedule, M, H, V):
    """The hybrid schedule's three kernels (the XLA forward's two backward
    ones) against the plain twin's VJP, about 40% of the rows PAD (weight
    0; label 0, or on every other PAD row a label past V), row 0 live: the
    loss to 1e-5, db to 1e-4 of its largest element, dh and dW to 1e-3 (as
    the flash kernels'); rows of weight 0 get dh = 0 exactly; the written
    logits bit for bit but where another f32 sum order crosses a bf16
    rounding boundary: each element that differs is the rounding of a
    value within 1e-5 of the plain f32 logit (2.5e-4 of the elements at H
    = 512).  The shapes cover the backward's 64-row tiles: one row, one
    row past a tile, the train shapes, every width, and a vocabulary
    smaller than a tile."""
    fn, plain = {"hybrid": (fused_linear_ce_hybrid, fused_linear_ce_hybrid_plain),
                 "xla_bwd": (fused_linear_ce_xla_bwd,
                             fused_linear_ce_xla_bwd_plain)}[schedule]
    g = torch.Generator(device=dev).manual_seed(M + V)
    h = torch.tanh(torch.randn((M, H), generator=g, device=dev))
    w = 0.05 * torch.randn((V, H), generator=g, device=dev)
    b = 0.1 * torch.randn((V,), generator=g, device=dev)
    labels = torch.randint(1, V, (M,), generator=g, device=dev)
    mask = (torch.rand((M,), generator=g, device=dev) > 0.4).float()
    mask[0] = 1.0
    labels[mask == 0] = 0
    labels[torch.nonzero(mask == 0)[1::2, 0]] = V + 7
    weights = mask / mask.sum()
    leaves = [[t.clone().requires_grad_() for t in (h, w, b)] for _ in range(2)]
    before = dict(_ext.LAUNCHES)
    fwd_clustered = _ext.library().vct_fused_ce_mat_fwd_cluster_launches()
    losses = []
    for f, lv in zip((fn, plain), leaves):
        loss = f(*lv, labels, weights)
        loss.backward()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    # the hybrid's forward at resident widths past 512 (576 and 1024 here)
    # ran in clusters; the XLA forward launches no forward kernel
    Hp = ce_width(H)
    assert (_ext.library().vct_fused_ce_mat_fwd_cluster_launches() - fwd_clustered
            == (1 if schedule == "hybrid" and fwd_cluster(Hp, True) else 0))
    assert fwd_cluster(Hp, True) == (2 if Hp in (576, 1024) else 0)
    want = {"mat_fwd": 1 if schedule == "hybrid" else 0, "mat_dh": 1,
            "mat_dwdb": 1, "fwd": 0, "dh": 0, "dwdb": 0}
    for name, n in want.items():
        key = f"fused_linear_ce_{name}"
        assert _ext.LAUNCHES[key] == before[key] + n, key
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    for name, a, r, tol in zip(("dh", "dw", "db"), leaves[0], leaves[1],
                               (1e-3, 1e-3, 1e-4)):
        assert a.grad.dtype == torch.float32 and bool(torch.isfinite(a.grad).all())
        assert _rel(a.grad, r.grad) < tol, name
    assert not leaves[0][0].grad[mask == 0].any()
    if schedule == "hybrid":
        lg, lse, ll = ce_mat_fwd_kernel(*prepare(*pad_ce(h, w), b, labels))
        p_lg, p_lse, p_ll = ce_mat_fwd_plain(h, w, b, labels)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=0)
        assert _rel(ll, p_ll) < 1e-5
        assert torch.equal(lg[:, V:], p_lg[:, V:])
        diff = lg[:, :V] != p_lg[:, :V]
        got = lg[:, :V].float()[diff]
        S = (h.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t() + b)[diff]
        half_step = torch.ldexp(torch.ones_like(got), torch.frexp(got).exponent - 9)
        assert bool(((got - S).abs() <= half_step + 1e-5).all())
        # the share that crosses a boundary grows with the sum's length:
        # 1e-3 up to H = 512, in proportion past it (1.08e-3 measured at
        # H = 2048)
        assert int(diff.sum()) <= 1e-3 * max(1.0, H / 512) * diff.numel()


@pytest.mark.parametrize("prior", ["Normal", "AG", "GMM", "GMM-ce_hybrid",
                                   "GMM-ce_xla_bwd"])
def test_train_steps_through_kernels_match_plain(dev, prior):
    """The GMM cases train with the flash CE (``fused_ce``), the hybrid
    and the XLA-forward CE; each case's two Trainers draw the same
    clusters from generators of the same seed."""
    from vae_captioning_torch.models.cvae import PLAIN_TRAIN_OPS
    from vae_captioning_torch.train import Trainer
    prior, _, flag = prior.partition("-")
    cfg = Config(embed_size=64, latent_size=16, encoder_hidden=64,
                 decoder_hidden=128, gen_z_samples=4, prior=prior,
                 use_c_v=prior == "AG", **{flag or "fused_ce": prior == "GMM"})
    cfg.vocab_size = 300
    rng = np.random.default_rng(0)
    B, K, T = 8, 5, 12
    lengths = rng.integers(2, T + 1, size=B * K).astype(np.int32)
    labels = rng.integers(3, 300, size=(B * K, T))
    labels[np.arange(T)[None, :] >= lengths[:, None]] = 0
    arrays = (torch.randn((B, 4096), device=dev),
              torch.from_numpy(labels).to(dev),
              torch.from_numpy(np.roll(labels, 1, axis=1)).to(dev),
              torch.from_numpy(lengths).to(dev),
              torch.from_numpy(rng.dirichlet(np.ones(90), size=B)
                               .astype(np.float32)).to(dev))
    runs, evals = [], []
    for ops in (None, PLAIN_TRAIN_OPS):
        tr = Trainer(cfg.replace(), device=dev, **({} if ops is None else {"ops": ops}))
        runs.append([{k: float(v) for k, v in tr.run_step_arrays(arrays).items()}
                     for _ in range(3)])
        # the eval step runs without gradients, so its conditioning steps
        # (encoder: image and, with c_v, the cluster vector; decoder:
        # image, c_v, z) take the decode kernel
        before = _ext.LAUNCHES["fused_lstm_step"]
        clusters = torch.Generator(device=dev).manual_seed(5)
        evals.append(float(tr.eval_step(*arrays, z_seed=3, clusters=clusters)))
        assert (_ext.LAUNCHES["fused_lstm_step"] - before
                == (5 if cfg.use_c_v else 3))
    for got, want in zip(*runs):
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(got[key] - want[key]) <= 2e-3 * abs(want[key]), key
    assert abs(evals[0] - evals[1]) <= 2e-3 * abs(evals[1])


@pytest.mark.parametrize("ce", ["fused_ce", "ce_hybrid", "ce_xla_bwd"])
def test_f32_route_launches_what_the_jax_package_runs(dev, ce):
    """Under compute_dtype="float32" (the JAX package's f32 route) at E =
    72, H = 100: a train step under a CE flag launches that schedule's CE
    kernels once each and no LSTM, z or AG heads kernel, its metrics to
    2e-3 of the same step on the CE's plain twin; beam-3 decodes, bf16
    and int8 head, launch their logits kernel once a step and no LSTM step
    kernel, with the plain decode's tokens (scores to rtol 1e-4)."""
    from vae_captioning_torch.models.cvae import F32_TRAIN_OPS, PLAIN_TRAIN_OPS
    from vae_captioning_torch.train import Trainer
    cfg = Config(embed_size=72, latent_size=16, encoder_hidden=100,
                 decoder_hidden=100, gen_z_samples=4, prior="AG", use_c_v=True,
                 compute_dtype="float32", gen_max_len=8, beam_size=3,
                 **{ce: True})
    cfg.vocab_size = 300
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(297)])
    rng = np.random.default_rng(0)
    B, K, T = 8, 5, 12
    lengths = rng.integers(2, T + 1, size=B * K).astype(np.int32)
    labels = rng.integers(3, 300, size=(B * K, T))
    labels[np.arange(T)[None, :] >= lengths[:, None]] = 0
    arrays = (torch.randn((B, 4096), device=dev),
              torch.from_numpy(labels).to(dev),
              torch.from_numpy(np.roll(labels, 1, axis=1)).to(dev),
              torch.from_numpy(lengths).to(dev),
              torch.from_numpy(rng.dirichlet(np.ones(90), size=B)
                               .astype(np.float32)).to(dev))
    plain_ce = F32_TRAIN_OPS._replace(**{f: getattr(PLAIN_TRAIN_OPS, f) for f in (
        "linear_ce", "linear_ce_hybrid", "linear_ce_xla_bwd")})
    want_ce = {"fused_ce": ("fused_linear_ce_fwd", "fused_linear_ce_dh",
                            "fused_linear_ce_dwdb"),
               "ce_hybrid": ("fused_linear_ce_mat_fwd", "fused_linear_ce_mat_dh",
                             "fused_linear_ce_mat_dwdb"),
               "ce_xla_bwd": ("fused_linear_ce_mat_dh",
                              "fused_linear_ce_mat_dwdb")}[ce]
    runs = []
    for ops, want in ((None, dict.fromkeys(want_ce, 1)), (plain_ce, {})):
        tr = Trainer(cfg.replace(), device=dev, **({} if ops is None else {"ops": ops}))
        torch.cuda.synchronize()
        before = dict(_ext.LAUNCHES)
        runs.append({k: float(v) for k, v in tr.run_step_arrays(arrays).items()})
        torch.cuda.synchronize()
        got = {k: v - before.get(k, 0) for k, v in _ext.LAUNCHES.items()
               if v != before.get(k, 0)}
        assert got == want, (ops is None, got)
        if ops is None:
            model = tr.model.eval()
    for key in ("loss", "rec_loss", "kld", "grad_norm"):
        assert abs(runs[0][key] - runs[1][key]) <= 2e-3 * abs(runs[1][key]), key
    feats, c_v = arrays[0][:B], arrays[4]
    for int8, name in ((False, "fused_logits_top_k"),
                       (True, "fused_logits_top_k_int8")):
        c = cfg.replace(decode_int8=int8)
        torch.cuda.synchronize()
        before = dict(_ext.LAUNCHES)
        got = make_decode_fns(model, c, vocab)["beam_search"](feats, c_v, eps=feats[:, :72])
        torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0) for k, v in _ext.LAUNCHES.items()
                    if v != before.get(k, 0)}
        assert launched == {name: got.steps}, launched
        want = make_decode_fns(model, c, vocab, ops=PLAIN_OPS)["beam_search"](
            feats, c_v, eps=feats[:, :72])
        assert torch.equal(got.tokens, want.tokens)
        torch.testing.assert_close(got.scores, want.scores, rtol=1e-4, atol=0)
