"""The configurations the port opened in ROADMAP A.11, against the JAX
package: deep stacks (``encoder_rnn_layers = decoder_rnn_layers = 2``),
the decoder's LSTM output dropout (``dec_lstm_drop``), the f32 compute
path (``compute_dtype = "float32"``) and widths no kernel is built for
(E = 40, H = 48).

* The train step: one forward + backward of the loss (annealing 0.5) on
  the same Flax weights and the same noise, every metric and every
  parameter's gradient against ``jax.grad`` of the JAX model's loss, and
  3 ``Trainer`` steps against the JAX ``make_train_step``.  Under bf16
  the JAX side runs its kernel path (``fused_force``) with the Pallas
  kernels in interpret mode and its fused z's normals patched to a
  deterministic function (as tests/test_torch_train.py does); under f32
  it runs XLA for the LSTMs, z and AG heads (its bf16-gated kernels) and
  its CE kernels under a CE flag, with ``sample_gaussian`` patched to
  the same eps the port is given.
* The decode: beam 3, greedy tokens (and beam scores) against the JAX
  decode fns on the same eps (its fused top-k in interpret mode; under
  f32 after f32 XLA LSTM steps, and also its int8 top-k and its unfused
  f32 logits).  Decode weights padded once to the kernels' widths decode
  as the unpadded ones.
* Dropout: at keep 1.0 the dropout source changes nothing; at keep 0.7
  a train step of a 2-layer stack with the JAX model's own Bernoulli
  draws handed in equals its ``jax.grad`` step; with fixed masks, the
  stack's output-masked sequence equals a step-by-step stack built the
  JAX way (``step`` + ``_maybe_drop``, carry copied through masked
  steps); and the Trainer's masks keep 0.7 of the outputs within 3σ.

Tolerances (each measured on these inputs, then given a margin): bf16
metrics METRIC_RTOL of tests/test_torch_train.py; bf16 gradients
BF16_GRAD_REL in relative L2 norm (measured: at most 5e-3 for every
weight, 2e-2 for the logits bias, whose gradient the bf16 head rounds;
the two sides round different products to bf16 in different sum
orders); f32 metrics and gradients F32_RTOL, elementwise, with an atol
of F32_RTOL times the largest element (f32 sums in another order);
decode tokens exactly, beam scores to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.experimental import pallas as pl

from vae_captioning_tpu import inference as jinf
from vae_captioning_tpu import train as jtrain
from vae_captioning_tpu.config import Config
from vae_captioning_tpu.data.vocabulary import Vocabulary
from vae_captioning_tpu.models.cvae import compute_loss as j_compute_loss
from vae_captioning_tpu.ops import distributions as jdist
from vae_captioning_tpu.ops import fused_z as jfz
from vae_captioning_torch import inference as tinf
from vae_captioning_torch import train as ttrain
from vae_captioning_torch.bridge import (flax_layout, load_flax_params,
                                         to_flax_array)
from vae_captioning_torch.models.cvae import (F32_TRAIN_OPS, CVAEModel,
                                              TrainOps, compute_loss)
from vae_captioning_torch.ops import lstm as tlstm
from vae_captioning_torch.ops.f32 import z_project_f32
from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq_plain
from vae_captioning_torch.ops.fused_z import fused_z_plain

B, K, T, V = 2, 3, 6, 50
CLUSTERS = 12
METRIC_RTOL = 3e-3
BF16_GRAD_REL = 3e-2
F32_RTOL = 1e-5
VOCAB = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(V - 3)])


def _fake_normal(seed0, seed1, s, tag, shape):
    r = (jax.lax.broadcasted_iota(jnp.int32, shape, 0) * 37
         + jax.lax.broadcasted_iota(jnp.int32, shape, 1) * 11 + s * 101)
    return ((r % 97).astype(jnp.float32) / 48.5) - 1.0


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jfz, "_normal_tile", _fake_normal)


def _cfg(prior="Normal", **kw):
    base = dict(embed_size=128, encoder_hidden=128, decoder_hidden=128,
                latent_size=16, gen_z_samples=4, prior=prior,
                compute_dtype="bfloat16", gen_max_len=6, beam_size=3)
    if prior == "AG":
        base.update(use_c_v=True, num_clusters=CLUSTERS)
    base.update(kw)
    cfg = Config(**base)
    cfg.vocab_size = V
    cfg.fused_force = base["compute_dtype"] == "bfloat16"
    return cfg


def _params(cfg):
    _, params = jtrain.init_model(cfg.replace(fused_force=False),
                                  jax.random.PRNGKey(0))
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    return params, flat


def _batch(seed=0, prior="Normal"):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, T + 1, size=B * K).astype(np.int32)
    lens[0] = T
    enc = rng.integers(3, V, size=(B * K, T)).astype(np.int32)
    dec = np.roll(enc, 1, axis=1)
    dec[:, 0] = 1
    for i in range(B * K):
        enc[i, lens[i]:] = 0
        dec[i, lens[i]:] = 0
    feats = rng.normal(size=(B, 4096)).astype(np.float32)
    cv = None
    if prior == "AG":
        cv = np.zeros((B, CLUSTERS), np.float32)
        for row in cv:
            row[rng.choice(CLUSTERS, size=rng.integers(1, 4), replace=False)] = 1.0
        cv /= cv.sum(axis=1, keepdims=True)
    return feats, enc, dec, lens, cv


def _bf16_eps(cfg):
    return np.array(jfz.sample_project_debug_eps(
        jnp.asarray([0, 0], jnp.int32), B * K, cfg.latent_size,
        cfg.gen_z_samples))


def _f32_eps(cfg, seed=5):
    return np.random.default_rng(seed).normal(
        size=(B * K, cfg.gen_z_samples, cfg.latent_size)).astype(np.float32)


@pytest.fixture()
def f32_noise(monkeypatch):
    """The JAX f32 path's z draws replaced by μ + σ·eps for a fixed eps."""
    box = {}

    def sample_gaussian(key, mean, std, num_samples, dtype=None):
        eps = box.get("eps")
        if eps is None or eps.shape[0] != mean.shape[0]:   # the init pass
            eps = np.zeros((mean.shape[0], num_samples, mean.shape[1]),
                           np.float32)
        z = mean[:, None, :] + std[:, None, :] * jnp.asarray(eps)
        return z if dtype is None else z.astype(dtype)

    monkeypatch.setattr(jdist, "sample_gaussian", sample_gaussian)
    return box


def _port_ops(cfg, eps):
    eps_t = torch.from_numpy(eps)
    if cfg.compute_dtype == "float32":
        return F32_TRAIN_OPS._replace(
            sample_project=lambda mean, std, w, b, n, seed, step:
            z_project_f32(mean, std, w, b, n, eps=eps_t))
    return TrainOps(fused_lstm_seq_plain,
                    lambda mean, std, w, b, n, seed, step: fused_z_plain(
                        mean, std, w, b, n, eps=eps_t))


CE_KERNELS = {"fused_ce": "flash", "ce_hybrid": "hybrid", "ce_xla_bwd": "xla_bwd"}


def _jax_step(cfg, params, batch, dropout=False):
    """(losses, flat gradients) of one JAX forward + backward (with its
    dropout on under ``dropout``)."""
    feats, enc, dec, lens, cv = batch
    model = jtrain.build_model(cfg)
    means = jnp.asarray(jdist.init_cluster_means(cfg.num_clusters,
                                                 cfg.latent_size, cfg.seed))
    ce = next((CE_KERNELS[f] for f in CE_KERNELS if getattr(cfg, f)), None)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(feats), jnp.asarray(enc),
                          jnp.asarray(dec), jnp.asarray(lens),
                          None if cv is None else jnp.asarray(cv),
                          deterministic=not dropout,
                          rngs={"z": jax.random.PRNGKey(3),
                                "sample": jax.random.PRNGKey(4),
                                "dropout": jax.random.PRNGKey(5)},
                          time_major=True, return_hidden=ce is not None)
        losses = j_compute_loss(
            out, jnp.asarray(enc).T, prior=cfg.prior, no_encoder=False,
            cluster_means=means, annealing=0.5, time_major=True,
            ce_kernel=ce or "flash",
            logits_params=(p["decoder"]["rnn_logits"]["kernel"],
                           p["decoder"]["rnn_logits"]["bias"])
            if ce else None)
        return losses["loss"], losses

    grads, losses = jax.grad(loss_fn, has_aux=True)(params)
    return ({k: float(v) for k, v in losses.items()},
            {"/".join(k): np.asarray(v)
             for k, v in flatten_dict(jax.device_get(grads)).items()})


def _port_step(cfg, flat, batch, ops, dropout=None):
    feats, enc, dec, lens, cv = batch
    model = CVAEModel.from_config(cfg)
    load_flax_params(model, flat)
    ttrain_args = ttrain._loss_args(model, cfg, ops)
    out = model(torch.from_numpy(feats), torch.from_numpy(enc).long(),
                torch.from_numpy(dec).long(), torch.from_numpy(lens),
                None if cv is None else torch.from_numpy(cv), ops=ops,
                time_major=True, dropout=dropout,
                return_hidden=ttrain_args["logits_params"] is not None)
    losses = compute_loss(out, torch.from_numpy(enc).long().t(),
                          annealing=0.5, **ttrain_args)
    losses["loss"].backward()
    params = dict(model.named_parameters())
    # the encoder reads its first layer's state, so its deeper layers get
    # no gradient: zeros, as jax.grad gives them
    grads = {key: to_flax_array(torch.zeros_like(params[name])
                                if params[name].grad is None
                                else params[name].grad, perm)
             for key, (name, perm) in flax_layout(model).items()}
    return {k: float(v) for k, v in losses.items()}, grads


def _check_step(got, want, metric_rtol, grad_rel, f32=False):
    (gm, gg), (wm, wg) = got, want
    for key in ("loss", "rec_loss", "kld"):
        assert abs(gm[key] - wm[key]) <= metric_rtol * abs(wm[key]), (key, gm, wm)
    assert set(gg) == set(wg)
    for key in wg:
        g, w = gg[key].astype(np.float64), wg[key].astype(np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        if f32:
            np.testing.assert_allclose(g, w, rtol=grad_rel,
                                       atol=grad_rel * scale, err_msg=key)
        else:
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= grad_rel, (key, rel)


# ----------------------------------------------------------------------
# deep stacks
# ----------------------------------------------------------------------

DEEP = dict(encoder_rnn_layers=2, decoder_rnn_layers=2)


@pytest.mark.parametrize("prior", ["Normal", "AG"])
def test_deep_stack_step_matches_jax(interpreted, prior):
    cfg = _cfg(prior, **DEEP)
    params, flat = _params(cfg)
    assert "decoder/lstm/cell_1/kernel" in flat
    assert "encoder/lstm/cell_1/kernel" in flat
    batch = _batch(seed=1, prior=prior)
    _check_step(_port_step(cfg, flat, batch, _port_ops(cfg, _bf16_eps(cfg))),
                _jax_step(cfg, params, batch), METRIC_RTOL, BF16_GRAD_REL)


def test_deep_stack_trainer_follows_the_jax_step(interpreted):
    cfg = _cfg("Normal", **DEEP)
    params, flat = _params(cfg)
    feats, enc, dec, lens, _ = _batch(seed=2)
    model = jtrain.build_model(cfg)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, cfg, donate=False)
    args = [jnp.asarray(a) for a in (feats, enc, dec, lens)]
    want = []
    for _ in range(3):
        state, m = step(state, *args, None, jax.random.PRNGKey(1))
        want.append({k: float(v) for k, v in m.items()})
    trainer = ttrain.Trainer(cfg.replace(), device="cpu", params=flat,
                             ops=_port_ops(cfg, _bf16_eps(cfg)))
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    for i in range(3):
        g = {k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(g[key] - want[i][key]) <= METRIC_RTOL * abs(want[i][key]), \
                (i, key, g, want[i])


def _decode_inputs(cfg, seed=0, n=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, 4096)).astype(np.float32)
    nc = cfg.num_clusters
    c_v = (rng.random((n, nc)) * (rng.random((n, nc)) < 0.3)).astype(np.float32)
    eps = rng.normal(size=(n, cfg.embed_size)).astype(np.float32)
    return feats, c_v, eps


def _jax_decode(cfg, params, feats, c_v, eps, name, monkeypatch):
    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps.shape
        return jnp.asarray(eps, dtype)

    with monkeypatch.context() as patch:
        patch.setattr(jax.random, "normal", normal)
        fns = jinf.make_decode_fns(jtrain.build_model(cfg), cfg, VOCAB)
        return fns[name](params, jnp.asarray(feats), jnp.asarray(c_v),
                         jax.random.PRNGKey(0))


def _check_decode(cfg, params, flat, monkeypatch, seed=0):
    model = CVAEModel.from_config(cfg)
    load_flax_params(model, flat)
    feats, c_v, eps = _decode_inputs(cfg, seed)
    fns = tinf.make_decode_fns(model, cfg, VOCAB)
    args = (torch.from_numpy(feats), torch.from_numpy(c_v))
    for name in ("beam_search", "greedy"):
        got = fns[name](*args, eps=torch.from_numpy(eps))
        want = _jax_decode(cfg, params, feats, c_v, eps, name, monkeypatch)
        if name == "beam_search":
            want_tokens, want_scores = want
            np.testing.assert_allclose(got.scores.numpy(),
                                       np.asarray(want_scores), rtol=1e-4)
        else:
            want_tokens = want
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want_tokens))


def test_deep_decoder_decode_matches_jax(interpreted, monkeypatch):
    cfg = _cfg("AG", **DEEP)
    params, flat = _params(cfg)
    _check_decode(cfg, params, flat, monkeypatch)


def test_deep_decode_weights_step_every_layer():
    """DecodeWeights hold every decoder layer, and make_lstm_fn feeds
    each layer's h' to the next, as LSTMStack.step does."""
    cfg = _cfg("Normal", decoder_rnn_layers=3, embed_size=32,
               decoder_hidden=48, encoder_hidden=32)
    model = CVAEModel.from_config(cfg)
    weights = tinf.DecodeWeights.of(model)
    assert len(weights.lstm_w) == len(weights.lstm_b) == 3
    assert weights.lstm_w[1].shape == (96, 192)
    g = torch.Generator().manual_seed(0)
    carry = tuple((torch.randn(5, 48, generator=g),
                   torch.tanh(torch.randn(5, 48, generator=g))) for _ in range(3))
    x = torch.randn(5, 32, generator=g)
    with torch.no_grad():
        got_carry, got = tinf.make_lstm_fn(weights)(carry, x)
        want_carry, want = model.decoder.lstm.step(carry, x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for (gc, gh), (wc, wh) in zip(got_carry, want_carry):
        torch.testing.assert_close(gc, wc, rtol=0, atol=1e-6)
        torch.testing.assert_close(gh, wh, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# f32
# ----------------------------------------------------------------------

F32 = dict(compute_dtype="float32")


@pytest.mark.parametrize("prior,extra", [("Normal", {}), ("AG", {}),
                                         ("Normal", DEEP)],
                         ids=["Normal", "AG", "deep"])
def test_f32_step_matches_jax(f32_noise, prior, extra):
    cfg = _cfg(prior, **F32, **extra)
    params, flat = _params(cfg)
    eps = _f32_eps(cfg)
    f32_noise["eps"] = eps
    batch = _batch(seed=3, prior=prior)
    _check_step(_port_step(cfg, flat, batch, _port_ops(cfg, eps)),
                _jax_step(cfg, params, batch), F32_RTOL, F32_RTOL, f32=True)


def test_f32_path_launches_no_kernel_and_logits_are_f32():
    """The f32 model's logits are f32 and its ops take the JAX package's
    f32 route: the LSTM sequence, z and AG heads in plain f32, the CE
    schedules on their kernel wrappers, the decode's LSTM step in plain
    f32 and its logits functions the kernel wrappers.  On the CPU its step
    and decode count no kernel launch."""
    from vae_captioning_torch import _ext
    from vae_captioning_torch.models.cvae import KERNEL_TRAIN_OPS, train_ops
    from vae_captioning_torch.ops.f32 import (ag_heads_f32, lstm_seq_f32,
                                              lstm_step_f32, z_project_f32)

    cfg = _cfg("AG", **F32, embed_size=32, encoder_hidden=32, decoder_hidden=32)
    ops = train_ops(cfg)
    assert (ops.lstm_seq, ops.sample_project, ops.ag_heads) == (
        lstm_seq_f32, z_project_f32, ag_heads_f32)
    assert ops[3:] == KERNEL_TRAIN_OPS[3:]
    decode_ops = tinf.route(tinf.KERNEL_OPS, torch.float32)
    assert decode_ops.lstm_step is lstm_step_f32
    assert decode_ops[1:] == tinf.KERNEL_OPS[1:]
    _ext.reset_launches()
    trainer = ttrain.Trainer(cfg, device="cpu")
    feats, enc, dec, lens, cv = _batch(seed=4, prior="AG")
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.from_numpy(cv))
    m = [trainer.run_step_arrays(arrays) for _ in range(3)]
    assert float(m[2]["loss"]) < float(m[0]["loss"])
    out = trainer.model(*arrays[:4], arrays[4], ops=F32_TRAIN_OPS)
    assert out["logits"].dtype == torch.float32
    feats, c_v, eps = _decode_inputs(cfg)
    res = tinf.make_decode_fns(trainer.model, cfg, VOCAB)["beam_search"](
        torch.from_numpy(feats), torch.from_numpy(c_v),
        eps=torch.from_numpy(eps))
    assert res.tokens.shape == (4, cfg.gen_max_len)
    assert not any(_ext.LAUNCHES.values())


@pytest.mark.parametrize("route", [{}, {"decode_int8": True},
                                   {"fused_decode": False}],
                         ids=["fused", "int8", "unfused"])
def test_f32_decode_matches_jax(interpreted, monkeypatch, route):
    """The JAX decode on its accelerator route (``fused_force``): f32 XLA
    LSTM steps, then its logits kernels (bf16, or int8), or, with
    ``fused_decode`` off, f32 logits."""
    cfg = _cfg("AG", **F32, **route).replace(fused_force=True)
    params, flat = _params(cfg)
    _check_decode(cfg, params, flat, monkeypatch, seed=1)


@pytest.mark.parametrize("ce", list(CE_KERNELS))
def test_f32_step_under_a_ce_flag_matches_jax(interpreted, f32_noise, ce):
    """Under f32 with a CE schedule flag the JAX package runs its CE
    kernels (h and the head cast to bf16 inside) after f32 XLA LSTMs:
    the port's f32 step, whose CE is the flag's kernel wrapper, against
    it at the bf16 tolerances (the CE's bf16 products)."""
    cfg = _cfg("Normal", **F32, **{ce: True}).replace(fused_force=True)
    params, flat = _params(cfg)
    eps = _f32_eps(cfg, seed=7)
    f32_noise["eps"] = eps
    batch = _batch(seed=9)
    _check_step(_port_step(cfg, flat, batch, _port_ops(cfg, eps)),
                _jax_step(cfg, params, batch), METRIC_RTOL, BF16_GRAD_REL)


def test_f32_trainer_follows_the_jax_step(f32_noise):
    """3 Adam steps: every step's metrics to F32_RTOL."""
    cfg = _cfg("Normal", **F32)
    params, flat = _params(cfg)
    eps = _f32_eps(cfg, seed=6)
    f32_noise["eps"] = eps
    feats, enc, dec, lens, _ = _batch(seed=5)
    model = jtrain.build_model(cfg)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, cfg, donate=False)
    args = [jnp.asarray(a) for a in (feats, enc, dec, lens)]
    trainer = ttrain.Trainer(cfg.replace(), device="cpu", params=flat,
                             ops=_port_ops(cfg, eps))
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    for i in range(3):
        state, m = step(state, *args, None, jax.random.PRNGKey(1))
        g = {k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            w = float(m[key])
            assert abs(g[key] - w) <= F32_RTOL * abs(w), (i, key, g[key], w)


# ----------------------------------------------------------------------
# widths no kernel is built for
# ----------------------------------------------------------------------

NARROW = dict(embed_size=40, encoder_hidden=48, decoder_hidden=48)


@pytest.mark.parametrize("fused_ce", [False, True], ids=["plain_ce", "flash_ce"])
def test_odd_widths_step_matches_jax(interpreted, fused_ce):
    cfg = _cfg("AG", fused_ce=fused_ce, **NARROW)
    params, flat = _params(cfg)
    batch = _batch(seed=7, prior="AG")
    _check_step(_port_step(cfg, flat, batch, _port_ops(cfg, _bf16_eps(cfg))),
                _jax_step(cfg, params, batch), METRIC_RTOL, BF16_GRAD_REL)


def test_odd_widths_decode_matches_jax(interpreted, monkeypatch):
    cfg = _cfg("AG", **NARROW)
    params, flat = _params(cfg)
    _check_decode(cfg, params, flat, monkeypatch, seed=2)


@pytest.mark.parametrize("route", [{}, {"decode_int8": True},
                                   {"fused_decode": False},
                                   {"compute_dtype": "float32"}],
                         ids=["bf16", "int8", "unfused", "f32"])
def test_decode_weights_padded_once_decode_as_unpadded(monkeypatch, route):
    """At E = 40, H = 48 the decode weights padded once to multiples of
    64 (as a card pads them: the embedding, every layer's kernel and gate
    blocks, the head and the int8 head) hold zeros past the real widths,
    and a decode from them (its carry at the padded H) gives the unpadded
    decode's tokens and scores."""
    cfg = _cfg("AG", **NARROW, decoder_rnn_layers=2, **route)
    model = CVAEModel.from_config(cfg)
    feats, c_v, eps = (torch.from_numpy(a) for a in _decode_inputs(cfg, seed=3))
    want = {name: fn(feats, c_v, eps=eps) for name, fn in
            tinf.make_decode_fns(model, cfg, VOCAB).items() if name != "sample"}
    of = tinf.DecodeWeights.of
    padded = {}

    def pad64(model, int8=False, **layout):
        padded["w"] = of(model, int8, **{**layout, "multiple": 64})
        return padded["w"]

    monkeypatch.setattr(tinf.DecodeWeights, "of", pad64)
    fns = tinf.make_decode_fns(model, cfg, VOCAB)
    w = padded["w"]
    assert w.embed.shape == (V, 64) and not w.embed[:, 40:].any()
    assert [tuple(k.shape) for k in w.lstm_w] == [(128, 256)] * 2
    assert w.lstm_w[1][48:64].abs().sum() == 0
    assert w.head_w.shape == (64, V) and w.head_w.t().is_contiguous()
    if w.head_wq is not None:
        assert w.head_wq.shape == (64, V) and not w.head_wq[48:].any()
    for name, res in want.items():
        got = fns[name](feats, c_v, eps=eps)
        assert torch.equal(got.tokens, res.tokens), name
        if res.scores is not None:
            torch.testing.assert_close(got.scores, res.scores, rtol=1e-5, atol=0)


# ----------------------------------------------------------------------
# the decoder's LSTM output dropout
# ----------------------------------------------------------------------

def _stack_inputs(N=7, T_=5, E=16, H=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, T_ + 1, (N,), generator=g)
    lengths[0] = T_
    return (torch.randn((N, T_, E), generator=g), lengths)


def test_keep_one_drops_nothing():
    stack = tlstm.LSTMStack(16, 24, 2, output_keep_rate=1.0)
    xs, lengths = _stack_inputs()
    carry = stack.zero_carry(xs.shape[0])
    with torch.no_grad():
        _, a = stack(carry, xs, lengths, seq_fn=fused_lstm_seq_plain)
        _, b = stack(carry, xs, lengths, seq_fn=fused_lstm_seq_plain,
                     dropout=torch.Generator().manual_seed(0))
        _, c = stack.step(carry, xs[:, 0], torch.Generator().manual_seed(0))
        _, d = stack.step(carry, xs[:, 0])
    assert torch.equal(a, b) and torch.equal(c, d)


class FixedMasks:
    """A dropout source handing out per-layer sequence masks [T, N, H]
    in order, and the JAX-way reference's per-step slices of them."""

    def __init__(self, layers, T_, N, H, keep, seed=0):
        g = torch.Generator().manual_seed(seed)
        self.masks = [torch.rand((T_, N, H), generator=g) < keep
                      for _ in range(layers)]
        self.calls = 0

    def __call__(self, shape):
        mask = self.masks[self.calls]
        self.calls += 1
        assert tuple(mask.shape) == tuple(shape)
        return mask


def test_output_dropout_equals_the_jax_step_by_step_stack():
    """The sequence form (each layer's kernel, then its output sequence
    masked) against JAX's ``nn.scan`` path written out: per step, every
    layer's ``step`` output dropped before the next layer, the carry
    copied through where t ≥ length and the output zeroed there.  The
    sequence form rounds a layer's output to bf16 before the mask (the
    kernel writes bf16 h), the step form after: ATOL is that bf16 step,
    measured 4e-3 here."""
    keep, layers, N, T_, E, H = 0.7, 2, 7, 5, 16, 24
    stack = tlstm.LSTMStack(E, H, layers, output_keep_rate=keep)
    xs, lengths = _stack_inputs(N, T_, E, H, seed=1)
    carry = stack.zero_carry(N)
    source = FixedMasks(layers, T_, N, H, keep, seed=2)
    with torch.no_grad():
        got_carry, got = stack(carry, xs, lengths, seq_fn=fused_lstm_seq_plain,
                               dropout=source)
        want_carry, outs = carry, []
        for t in range(T_):
            step_masks = iter(m[t] for m in source.masks)
            stepped, h = stack.step(want_carry, xs[:, t],
                                    lambda shape: next(step_masks))
            m = (t < lengths)[:, None]
            want_carry = tuple((torch.where(m, nc, c), torch.where(m, nh, h_))
                               for (nc, nh), (c, h_) in zip(stepped, want_carry))
            outs.append(torch.where(m, h, 0.0))
        want = torch.stack(outs, dim=1)
    assert source.calls == layers
    assert torch.equal(got == 0, want == 0)          # masked and dropped alike
    torch.testing.assert_close(got.float(), want, rtol=0, atol=1e-2)
    for (gc, gh), (wc, wh) in zip(got_carry, want_carry):
        torch.testing.assert_close(gc, wc, rtol=0, atol=1e-2)
        torch.testing.assert_close(gh, wh, rtol=0, atol=1e-2)


class SequenceMasks:
    """The port's dropout source holding the JAX model's Bernoulli draws:
    its ``steps`` conditioning-step masks [N, H] (each layer's, step by
    step) in order, then, for each layer, its per-step masks stacked into
    the sequence's [T, N, H]."""

    def __init__(self, drawn, steps, layers):
        cond, seq = drawn[:steps * layers], drawn[steps * layers:]
        T_ = len(seq) // layers
        self.masks = [torch.from_numpy(m) for m in cond] + [
            torch.from_numpy(np.stack([seq[t * layers + l] for t in range(T_)]))
            for l in range(layers)]
        self.calls = 0

    def __call__(self, shape):
        mask = self.masks[self.calls]
        self.calls += 1
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        return mask


def test_output_dropout_step_matches_jax(interpreted, monkeypatch):
    """A train step of 2 encoder and 2 decoder layers under dec_lstm_drop
    = 0.7: the JAX model runs with its dropout on (``deterministic=False``:
    ``_maybe_drop`` in the conditioning steps and its ``nn.scan`` path),
    its ``jax.random.bernoulli`` draws recorded in order; the port
    runs the same step with those masks handed in (``SequenceMasks``).
    Every metric and gradient against ``jax.grad``, at the bf16
    tolerances."""
    cfg = _cfg("Normal", **DEEP, dec_lstm_drop=0.7)
    params, flat = _params(cfg)
    batch = _batch(seed=11)
    drawn = []
    bernoulli = jax.random.bernoulli

    def recorded(key, p, shape):
        mask = bernoulli(key, p, shape)
        # ordered: the draws reach the host in program order (the
        # conditioning steps', then the scan's, layer by layer each step)
        jax.debug.callback(lambda m: drawn.append(np.array(m)), mask,
                           ordered=True)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", recorded)
    want = _jax_step(cfg, params, batch, dropout=True)
    layers, H = 2, cfg.decoder_hidden
    # 2 conditioning steps (image, z) and T caption steps, a draw a layer
    assert len(drawn) == (2 + T) * layers
    assert all(m.shape == (B * K, H) for m in drawn)
    kept = np.concatenate([m.reshape(-1) for m in drawn]).mean()
    assert 0.6 < kept < 0.8
    source = SequenceMasks(drawn, 2, layers)
    got = _port_step(cfg, flat, batch, _port_ops(cfg, _bf16_eps(cfg)),
                     dropout=source)
    assert source.calls == len(source.masks)
    _check_step(got, want, METRIC_RTOL, BF16_GRAD_REL)


def test_trainer_drops_lstm_outputs_at_the_keep_rate():
    """Under dec_lstm_drop = 0.7 the Trainer's step draws masks from its
    device generator for each decoder layer's outputs (and the
    conditioning steps'), keeping 0.7 of them within 3σ; eval and decode
    never drop."""
    cfg = _cfg("Normal", dec_lstm_drop=0.7, decoder_rnn_layers=2,
               embed_size=32, encoder_hidden=32, decoder_hidden=32,
               compute_dtype="bfloat16")
    trainer = ttrain.Trainer(cfg, device="cpu")
    assert isinstance(trainer.dropout, torch.Generator)
    feats, enc, dec, lens, _ = _batch(seed=8)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    masks = []

    def recording(shape):
        mask = tlstm.keep_mask(trainer.dropout, shape, 0.7, torch.device("cpu"))
        masks.append(mask)
        return mask

    m = trainer.train_step(0, *arrays, z_seed=1, dropout=recording)
    assert np.isfinite(float(m["loss"]))
    # 2 conditioning steps (image, z) x 2 layers, then the sequence's 2
    assert [tuple(x.shape) for x in masks] == [(B * K, 32)] * 4 + [(T, B * K, 32)] * 2
    kept = torch.cat([x.reshape(-1) for x in masks]).float()
    sigma = (0.7 * 0.3 / kept.numel()) ** 0.5
    assert abs(float(kept.mean()) - 0.7) <= 3 * sigma
    first = trainer.eval_step(*arrays, z_seed=1)
    assert float(trainer.eval_step(*arrays, z_seed=1)) == float(first)
    assert np.isfinite(float(trainer.run_step_arrays(arrays)["loss"]))
