"""The train slice of the port (vae_captioning_torch/train.py and the
training forward of models/cvae.py) against the JAX package: the forward
and the loss, a 3-step ``make_train_step`` trajectory (Normal prior; AG
prior with both ``ag_kl_sum`` settings; GMM prior with the flash CE and
both ``gmm_true_kl`` settings, and under the hybrid and XLA-forward CE
schedules), the optimizer against optax, KL
annealing, ``Trainer.fit`` and ``cli --mode training`` on the synthetic
mini-COCO, and the configurations that raise.

The JAX side runs its kernel path (``cfg.fused_force``) with the Pallas
kernels in interpret mode and ``fused_z._normal_tile`` patched to a
deterministic function, as ``tests/test_fused_z.py`` does; the port is
handed the same numbers as the fused z's explicit eps.  The GMM cases
patch ``jax.random.categorical`` to return fixed cluster indices and hand
the port the same indices.  E and H are 128, the lane width the JAX
kernels need.  The AG cases use L = 150 and 12 clusters, so the JAX heads
kernel runs two groups of 8 clusters, the last one padded; the GMM cases
12 clusters of L = 16."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.experimental import pallas as pl

from vae_captioning_tpu import train as jtrain
from vae_captioning_tpu.config import Config
from vae_captioning_tpu.models.cvae import compute_loss as j_compute_loss
from vae_captioning_tpu.models.cvae import logits_head_params
from vae_captioning_tpu.ops import distributions as jdist
from vae_captioning_tpu.ops import fused_z as jfz
from vae_captioning_torch import checkpoint as ckpt
from vae_captioning_torch import cli as tcli
from vae_captioning_torch import train as ttrain
from vae_captioning_torch.bridge import export_flax_params, load_flax_params
from vae_captioning_torch.data.dataset import Data
from vae_captioning_torch.data.features import FeatureStore
from vae_captioning_torch.inference import run_inference
from vae_captioning_torch.models.cvae import (CVAEModel, TrainOps,
                                              compute_loss)
from vae_captioning_torch.ops import distributions as tdist
from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq_plain
from vae_captioning_torch.ops.fused_z import fused_z_plain

B, K, T, V = 2, 3, 6, 50
# loss, rec_loss, kld and grad_norm: f32 sums in another order and the
# odd bf16 value rounded the other way (measured: 5e-4 at most over 3 steps)
METRIC_RTOL = 3e-3
# the AG posterior: the JAX kernel rounds each c_v-weighted product to
# bf16 before it folds the clusters, the port keeps them in f32; so q_mean
# and q_std to its test's 6e-3 of their largest element
AG_REL = 6e-3
AG_K, AG_L = 12, 150


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


def _cfg(**kw):
    base = dict(embed_size=128, encoder_hidden=128, decoder_hidden=128,
                latent_size=16, gen_z_samples=4, prior="Normal",
                compute_dtype="bfloat16")
    base.update(kw)
    cfg = Config(**base)
    cfg.vocab_size = V
    cfg.fused_force = True          # JAX: the kernel path on the CPU
    return cfg


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, T + 1, size=B * K).astype(np.int32)
    lens[0] = T
    enc = rng.integers(3, V, size=(B * K, T)).astype(np.int32)
    dec = np.roll(enc, 1, axis=1)
    dec[:, 0] = 1
    for i in range(B * K):
        enc[i, lens[i]:] = 0
        dec[i, lens[i]:] = 0
    return rng.normal(size=(B, 4096)).astype(np.float32), enc, dec, lens


def _ops(eps):
    """The plain versions, with the fused z fed the JAX kernels' eps."""
    eps_t = torch.from_numpy(eps)
    return TrainOps(fused_lstm_seq_plain,
                    lambda mean, std, w, b, n, seed, step: fused_z_plain(
                        mean, std, w, b, n, eps=eps_t))


@pytest.fixture(scope="module")
def jax_model():
    cfg = _cfg()
    # initialised off the kernel path (the same tree; a module fixture
    # runs before the interpret-mode patch), applied on it
    _, params = jtrain.init_model(cfg.replace(fused_force=False),
                                  jax.random.PRNGKey(0))
    model = jtrain.build_model(cfg)
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    return cfg, model, params, flat


def _eps(cfg):
    return np.array(jfz.sample_project_debug_eps(
        jnp.asarray([0, 0], jnp.int32), B * K, cfg.latent_size,
        cfg.gen_z_samples))


def _ag_cfg(**kw):
    return _cfg(prior="AG", use_c_v=True, latent_size=AG_L,
                num_clusters=AG_K, **kw)


def _cv(seed):
    """[B, AG_K] cluster vectors as COCO gives them: 1-3 active clusters
    per image, normalised to sum to 1."""
    rng = np.random.default_rng(seed)
    cv = np.zeros((B, AG_K), np.float32)
    for row in cv:
        row[rng.choice(AG_K, size=rng.integers(1, 4), replace=False)] = 1.0
    return cv / cv.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def ag_jax_model():
    cfg = _ag_cfg()
    _, params = jtrain.init_model(cfg.replace(fused_force=False),
                                  jax.random.PRNGKey(0))
    model = jtrain.build_model(cfg)
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    return cfg, model, params, flat


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_forward_and_loss_match_jax(interpreted, jax_model):
    cfg, model, params, flat = jax_model
    feats, enc, dec, lens = _batch()
    out = model.apply({"params": params}, jnp.asarray(feats), jnp.asarray(enc),
                      jnp.asarray(dec), jnp.asarray(lens), None,
                      rngs={"z": jax.random.PRNGKey(3)}, time_major=True)
    j_loss = j_compute_loss(out, jnp.asarray(enc).T, prior="Normal",
                            no_encoder=False, annealing=0.5, time_major=True)
    t_model = CVAEModel.from_config(cfg)
    load_flax_params(t_model, flat)
    t_out = t_model(torch.from_numpy(feats), torch.from_numpy(enc).long(),
                    torch.from_numpy(dec).long(), torch.from_numpy(lens),
                    ops=_ops(_eps(cfg)), time_major=True)
    t_loss = compute_loss(t_out, torch.from_numpy(enc).long().t(),
                          no_encoder=False, annealing=0.5)
    # f32 heads over the same LSTM state: 1e-4; bf16 logits: one bf16 step
    for key in ("q_mean", "q_std"):
        np.testing.assert_allclose(t_out[key].detach().numpy(),
                                   np.asarray(out[key]), rtol=1e-4, atol=1e-4)
    assert t_out["logits"].dtype == torch.bfloat16
    assert t_out["logits"].shape == (T, B * K, V)
    np.testing.assert_allclose(t_out["logits"].float().detach().numpy(),
                               np.asarray(out["logits"], np.float32),
                               rtol=2e-2, atol=2e-2)
    for key in ("loss", "rec_loss", "kld", "annealing"):
        np.testing.assert_allclose(float(t_loss[key]), float(j_loss[key]),
                                   rtol=1e-4, err_msg=key)


def test_three_train_steps_match_jax(interpreted, jax_model):
    cfg, model, params, flat = jax_model
    feats, enc, dec, lens = _batch(seed=1)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, cfg, donate=False)
    args = [jnp.asarray(a) for a in (feats, enc, dec, lens)]
    want = []
    for _ in range(3):
        state, m = step(state, *args, None, jax.random.PRNGKey(1))
        want.append({k: float(v) for k, v in m.items()})
    trainer = ttrain.Trainer(cfg.replace(), device="cpu", params=flat,
                             ops=_ops(_eps(cfg)))
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    got = [{k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
           for _ in range(3)]
    assert trainer.host_step == 3
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(g[key] - w[key]) <= METRIC_RTOL * abs(w[key]), (i, key, g, w)
    # the trained weights moved alike: Adam moves an element whose
    # gradient is at noise level by up to lr either way, so the moves are
    # compared on average
    moved = export_flax_params(trainer.model)
    jp = {"/".join(k): np.asarray(v)
          for k, v in flatten_dict(jax.device_get(state.params)).items()}
    for key in ("decoder/rnn_logits/kernel", "encoder/q_heads/kernel",
                "decoder/lstm/cell_0/kernel"):
        delta_t, delta_j = moved[key] - flat[key], jp[key] - flat[key]
        assert (np.abs(delta_t - delta_j).mean()
                <= 0.02 * np.abs(delta_j).mean()), key


def test_ag_forward_and_loss_match_jax(interpreted, ag_jax_model):
    cfg, model, params, flat = ag_jax_model
    feats, enc, dec, lens = _batch(seed=6)
    cv = _cv(6)
    out = model.apply({"params": params}, jnp.asarray(feats), jnp.asarray(enc),
                      jnp.asarray(dec), jnp.asarray(lens), jnp.asarray(cv),
                      rngs={"z": jax.random.PRNGKey(3)}, time_major=True)
    means = jnp.asarray(jdist.init_cluster_means(AG_K, AG_L, cfg.seed))
    t_model = CVAEModel.from_config(cfg)
    load_flax_params(t_model, flat)
    t_out = t_model(torch.from_numpy(feats), torch.from_numpy(enc).long(),
                    torch.from_numpy(dec).long(), torch.from_numpy(lens),
                    c_v=torch.from_numpy(cv), ops=_ops(_eps(cfg)),
                    time_major=True)
    np.testing.assert_array_equal(t_model.cluster_means.numpy(), means)
    np.testing.assert_array_equal(t_out["c_v"].numpy(), np.asarray(out["c_v"]))
    for key in ("q_mean", "q_std"):
        assert _rel(t_out[key].detach(), out[key]) <= AG_REL, key
    np.testing.assert_allclose(t_out["logits"].float().detach().numpy(),
                               np.asarray(out["logits"], np.float32),
                               rtol=2e-2, atol=2e-2)
    for kl_sum in (False, True):
        j_loss = j_compute_loss(out, jnp.asarray(enc).T, prior="AG",
                                no_encoder=False, cluster_means=means,
                                annealing=0.5, ag_kl_sum=kl_sum,
                                time_major=True)
        t_loss = compute_loss(t_out, torch.from_numpy(enc).long().t(),
                              no_encoder=False, prior="AG",
                              cluster_means=t_model.cluster_means,
                              annealing=0.5, ag_kl_sum=kl_sum)
        # rec_loss as the Normal case; the KL moves with q_mean and q_std
        np.testing.assert_allclose(float(t_loss["rec_loss"]),
                                   float(j_loss["rec_loss"]), rtol=1e-4)
        for key in ("loss", "kld"):
            np.testing.assert_allclose(float(t_loss[key].detach()),
                                       float(j_loss[key]), rtol=METRIC_RTOL,
                                       err_msg=f"{key} ag_kl_sum={kl_sum}")


@pytest.mark.parametrize("kl_sum", [False, True])
def test_ag_three_train_steps_match_jax(interpreted, ag_jax_model, kl_sum):
    cfg, model, params, flat = ag_jax_model
    cfg = cfg.replace(ag_kl_sum=kl_sum)
    feats, enc, dec, lens = _batch(seed=7)
    cv = _cv(7)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, cfg, donate=False)
    args = [jnp.asarray(a) for a in (feats, enc, dec, lens, cv)]
    want = []
    for _ in range(3):
        state, m = step(state, *args, jax.random.PRNGKey(1))
        want.append({k: float(v) for k, v in m.items()})
    trainer = ttrain.Trainer(cfg.replace(), device="cpu", params=flat,
                             ops=_ops(_eps(cfg)))
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.from_numpy(cv))
    got = [{k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
           for _ in range(3)]
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(g[key] - w[key]) <= METRIC_RTOL * abs(w[key]), (i, key, g, w)
    # the heads moved alike (compared on average, as in the Normal case)
    moved = export_flax_params(trainer.model)
    jp = {"/".join(k): np.asarray(v)
          for k, v in flatten_dict(jax.device_get(state.params)).items()}
    for key in ("encoder/q_heads/kernel", "encoder/q_heads/bias",
                "cv_emb/kernel"):
        delta_t, delta_j = moved[key] - flat[key], jp[key] - flat[key]
        assert (np.abs(delta_t - delta_j).mean()
                <= 0.02 * np.abs(delta_j).mean()), key


@pytest.fixture(scope="module")
def gmm_jax_model():
    cfg = _cfg(prior="GMM", num_clusters=AG_K, fused_ce=True)
    _, params = jtrain.init_model(cfg.replace(fused_force=False),
                                  jax.random.PRNGKey(0))
    model = jtrain.build_model(cfg)
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    return cfg, model, params, flat


@pytest.fixture()
def fixed_clusters(monkeypatch):
    """The JAX GMM head's categorical draw replaced by fixed indices
    [B·K], which the port is handed too."""
    idx = np.random.default_rng(11).integers(0, AG_K, size=B * K)

    def categorical(key, logits, axis=-1, **kw):
        return jnp.asarray(idx[:logits.shape[0]], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    return torch.from_numpy(idx)


def _gmm_cv(seed):
    """The AG cases' cluster vectors with an all-zero row, whose mixture
    weights in ``kl_gmm`` fall back to uniform."""
    cv = _cv(seed)
    cv[1] = 0.0
    return cv


@pytest.mark.parametrize("fused_ce", [False, True])
def test_gmm_forward_and_loss_match_jax(interpreted, fixed_clusters,
                                        gmm_jax_model, fused_ce):
    """The GMM posterior (one cluster per row, picked by index in the
    port, by a one-hot contraction in the JAX package) and the loss with
    both KLs, over the bf16 logits or, with ``fused_ce``, through the
    flash CE over the decoder's hidden rows."""
    cfg, model, params, flat = gmm_jax_model
    feats, enc, dec, lens = _batch(seed=8)
    cv = _gmm_cv(8)
    out = model.apply({"params": params}, jnp.asarray(feats), jnp.asarray(enc),
                      jnp.asarray(dec), jnp.asarray(lens), jnp.asarray(cv),
                      rngs={"z": jax.random.PRNGKey(3),
                            "sample": jax.random.PRNGKey(4)},
                      time_major=True, return_hidden=fused_ce)
    means = jnp.asarray(jdist.init_cluster_means(AG_K, cfg.latent_size,
                                                 cfg.seed))
    t_model = CVAEModel.from_config(cfg)
    load_flax_params(t_model, flat)
    t_out = t_model(torch.from_numpy(feats), torch.from_numpy(enc).long(),
                    torch.from_numpy(dec).long(), torch.from_numpy(lens),
                    c_v=torch.from_numpy(cv), ops=_ops(_eps(cfg)),
                    time_major=True, return_hidden=fused_ce,
                    clusters=fixed_clusters)
    for key in ("q_mean", "q_std"):     # f32 heads over the same LSTM state
        np.testing.assert_allclose(t_out[key].detach().numpy(),
                                   np.asarray(out[key]), rtol=1e-4, atol=1e-4)
    key = "hidden" if fused_ce else "logits"
    assert key in t_out and t_out[key].dtype == torch.bfloat16
    np.testing.assert_allclose(t_out[key].float().detach().numpy(),
                               np.asarray(out[key], np.float32),
                               rtol=2e-2, atol=2e-2)
    head = t_model.decoder.rnn_logits
    for true_kl in (False, True):
        j_loss = j_compute_loss(
            out, jnp.asarray(enc).T, prior="GMM", no_encoder=False,
            cluster_means=means, annealing=0.5, gmm_true_kl=true_kl,
            logits_params=logits_head_params(params) if fused_ce else None,
            time_major=True, ce_kernel="flash")
        t_loss = compute_loss(
            t_out, torch.from_numpy(enc).long().t(), no_encoder=False,
            prior="GMM", cluster_means=t_model.cluster_means, annealing=0.5,
            gmm_true_kl=true_kl,
            logits_params=(head.weight, head.bias) if fused_ce else None)
        np.testing.assert_allclose(float(t_loss["rec_loss"].detach()),
                                   float(j_loss["rec_loss"]), rtol=1e-4)
        for k in ("loss", "kld"):
            np.testing.assert_allclose(float(t_loss[k].detach()),
                                       float(j_loss[k]), rtol=METRIC_RTOL,
                                       err_msg=f"{k} gmm_true_kl={true_kl}")


@pytest.mark.parametrize("true_kl", [False, True])
def test_gmm_fused_ce_three_train_steps_match_jax(interpreted, fixed_clusters,
                                                  gmm_jax_model, true_kl):
    """``Config(prior="GMM", fused_ce=True)``: the JAX step runs its flash
    CE kernels (interpret mode), the port its plain flash CE, over the
    same cluster draws."""
    cfg, model, params, flat = gmm_jax_model
    cfg = cfg.replace(gmm_true_kl=true_kl)
    feats, enc, dec, lens = _batch(seed=9)
    cv = _gmm_cv(9)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, cfg, donate=False)
    args = [jnp.asarray(a) for a in (feats, enc, dec, lens, cv)]
    want = []
    for _ in range(3):
        state, m = step(state, *args, jax.random.PRNGKey(1))
        want.append({k: float(v) for k, v in m.items()})
    trainer = ttrain.Trainer(cfg.replace(), device="cpu", params=flat,
                             ops=_ops(_eps(cfg)))
    assert isinstance(trainer.clusters, torch.Generator)
    trainer.clusters = fixed_clusters
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.from_numpy(cv))
    got = [{k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
           for _ in range(3)]
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(g[key] - w[key]) <= METRIC_RTOL * abs(w[key]), (i, key, g, w)
    # the heads and the logits head moved alike (compared on average, as
    # in the Normal case)
    moved = export_flax_params(trainer.model)
    jp = {"/".join(k): np.asarray(v)
          for k, v in flatten_dict(jax.device_get(state.params)).items()}
    for key in ("encoder/q_heads/kernel", "decoder/rnn_logits/kernel",
                "decoder/rnn_logits/bias"):
        delta_t, delta_j = moved[key] - flat[key], jp[key] - flat[key]
        assert (np.abs(delta_t - delta_j).mean()
                <= 0.02 * np.abs(delta_j).mean()), key


@pytest.mark.parametrize("schedule", ["ce_hybrid", "ce_xla_bwd"])
def test_gmm_written_logits_three_train_steps_match_jax(
        interpreted, fixed_clusters, gmm_jax_model, schedule):
    """``Config(prior="GMM", ce_hybrid=True)`` and ``(..., ce_xla_bwd=True)``:
    the JAX step runs the schedule's Pallas kernels (interpret mode), the
    port the plain twin that its flag means on the CPU, over the same
    cluster draws; the metrics to METRIC_RTOL, and the heads and the
    logits head moved alike."""
    cfg, model, params, flat = gmm_jax_model
    cfg = cfg.replace(fused_ce=False, **{schedule: True})
    feats, enc, dec, lens = _batch(seed=12)
    cv = _gmm_cv(12)
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, cfg, donate=False)
    args = [jnp.asarray(a) for a in (feats, enc, dec, lens, cv)]
    want = []
    for _ in range(3):
        state, m = step(state, *args, jax.random.PRNGKey(1))
        want.append({k: float(v) for k, v in m.items()})
    trainer = ttrain.Trainer(cfg.replace(), device="cpu", params=flat,
                             ops=_ops(_eps(cfg)))
    trainer.clusters = fixed_clusters
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.from_numpy(cv))
    got = [{k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
           for _ in range(3)]
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(g[key] - w[key]) <= METRIC_RTOL * abs(w[key]), (i, key, g, w)
    assert got[2]["loss"] < got[0]["loss"]
    moved = export_flax_params(trainer.model)
    jp = {"/".join(k): np.asarray(v)
          for k, v in flatten_dict(jax.device_get(state.params)).items()}
    for key in ("encoder/q_heads/kernel", "decoder/rnn_logits/kernel",
                "decoder/rnn_logits/bias"):
        delta_t, delta_j = moved[key] - flat[key], jp[key] - flat[key]
        assert (np.abs(delta_t - delta_j).mean()
                <= 0.02 * np.abs(delta_j).mean()), key


@pytest.mark.parametrize("schedule", ["fused_ce", "ce_hybrid", "ce_xla_bwd"])
def test_each_ce_flag_picks_its_ce_function(schedule):
    """The train and eval steps hand ``compute_loss`` the flag's CE
    function of their TrainOps (here a recorder) and the decoder's hidden
    rows; without a flag, the logits."""
    seen = []

    def recorder(name):
        def ce(h, w, b, labels, weights):
            seen.append((name, tuple(h.shape)))
            return (h.float().sum() * 0 + weights.sum()).reshape(())
        return ce

    cfg = _cfg(prior="GMM", num_clusters=6, embed_size=32, encoder_hidden=32,
               decoder_hidden=32, latent_size=8, **{schedule: True})
    ops = TrainOps(linear_ce=recorder("fused_ce"),
                   linear_ce_hybrid=recorder("ce_hybrid"),
                   linear_ce_xla_bwd=recorder("ce_xla_bwd"))
    trainer = ttrain.Trainer(cfg, device="cpu", ops=ops)
    feats, enc, dec, lens = _batch(seed=13)
    cv = np.random.default_rng(13).dirichlet(np.ones(6), size=B)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.from_numpy(cv.astype(np.float32)))
    trainer.run_step_arrays(arrays)
    trainer.eval_step(*arrays, z_seed=1, clusters=torch.Generator().manual_seed(0))
    assert seen == [(schedule, (T * B * K, 32))] * 2


@pytest.mark.parametrize("fused_ce", [False, True])
def test_gmm_trainer_draws_from_its_own_generator(fused_ce):
    """Two Trainers from one seed draw the same clusters and take the same
    steps; the eval step draws from a generator of its own."""
    cfg = _cfg(prior="GMM", num_clusters=6, fused_ce=fused_ce, embed_size=32,
               encoder_hidden=32, decoder_hidden=32, latent_size=8)
    feats, enc, dec, lens = _batch(seed=10)
    cv = np.random.default_rng(10).dirichlet(np.ones(6), size=B)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.from_numpy(cv.astype(np.float32)))
    runs = []
    for _ in range(2):
        trainer = ttrain.Trainer(cfg.replace(), device="cpu")
        runs.append([{k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
                     for _ in range(3)])
    assert runs[0] == runs[1]
    assert runs[0][2]["loss"] < runs[0][0]["loss"]
    with pytest.raises(ValueError, match="draws a cluster per row"):
        trainer.eval_step(*arrays, z_seed=1)
    assert np.isfinite(float(trainer.eval_step(
        *arrays, z_seed=1, clusters=torch.Generator().manual_seed(0))))


@pytest.mark.parametrize("kind", ["Adam", "SGD", "Momentum"])
def test_optimizer_matches_optax(kind):
    """Four updates on random gradients, the third one above the clip
    norm; the SGD and Momentum lr halves after every two updates."""
    cfg = Config(optimizer=kind, learning_rate=0.01, lstm_clip_by_norm=5.0,
                 num_ex_per_epoch=64, batch_size=32, num_epochs_per_decay=1)
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jtrain.make_optimizer(cfg)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
                for k in shapes]
    opt = ttrain.make_optimizer(cfg, t_params)
    for i in range(4):
        scale = 10.0 if i == 2 else 0.3
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, j_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                 j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        norm = opt.step([torch.from_numpy(grads[k]) for k in shapes])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()})), rtol=1e-6)
        if i == 2:
            assert float(norm) > cfg.lstm_clip_by_norm
        for k, p in zip(shapes, t_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{kind} {k} {i}")


@pytest.mark.parametrize("step,ann,force", [(0, 0.0, False), (0, 5.0, False),
                                            (4321, 5.0, False), (12000, 3.5, False),
                                            (10, 5.0, True)])
def test_kl_annealing_matches_jax(step, ann, force):
    want = jdist.kl_annealing(jnp.asarray(step, jnp.int32), ann, force)
    got = tdist.kl_annealing(step, ann, force)
    assert got.dtype == torch.float32
    # (tanh + 1) / 2 near tanh = -1 keeps one f32 ulp of tanh: atol 1e-7
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def test_kl_standard_normal_matches_jax():
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(6, 16)).astype(np.float32)
    std = rng.uniform(0.2, 2.0, size=(6, 16)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], bool)
    for m in (None, mask):
        want = jdist.kl_standard_normal(jnp.asarray(mean), jnp.asarray(std),
                                        None if m is None else jnp.asarray(m))
        got = tdist.kl_standard_normal(torch.from_numpy(mean),
                                       torch.from_numpy(std),
                                       None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _mini_cfg(mini_coco, tmp_path, **kw):
    base = dict(coco_dir=mini_coco, cache_dir=str(tmp_path / "cache"),
                obj_vectors_dir=str(tmp_path / "obj"),
                checkpoint_dir=str(tmp_path / "ckpt"), checkpoint="run",
                embed_size=32, encoder_hidden=32, decoder_hidden=32,
                latent_size=8, gen_z_samples=2, batch_size=4, num_epochs=1,
                num_ex_per_epoch=8, gen_val_captions=2, gen_max_len=5,
                beam_size=2, prefetch_batches=1, hdf5_file="",
                raw_images_file="")
    base.update(kw)
    return Config(**base)


def _feature_caches(mini_coco, cache_dir, splits=("train2014", "val2014",
                                                  "test2014")):
    rng = np.random.default_rng(0)
    os.makedirs(cache_dir, exist_ok=True)
    for split in splits:
        files = sorted(os.listdir(os.path.join(mini_coco, "images", split)))
        FeatureStore(files, rng.normal(size=(len(files), 4096))).save(
            os.path.join(cache_dir, f"{split}.features.npz"))


def _fit_then_decode(mini_coco, tmp_path, capsys, **overrides):
    cfg = _mini_cfg(mini_coco, tmp_path, **overrides)
    _feature_caches(mini_coco, cfg.cache_dir)
    data = Data(cfg, extract_features=True)
    trainer = ttrain.Trainer(cfg, vocab_size=data.vocab.vocab_size, device="cpu")
    ckpt.save_sidecars(cfg, data.vocab, cfg.checkpoint_dir, "run")
    before = export_flax_params(trainer.model)
    metrics = trainer.fit(data.train_batcher(), data.val_batcher(),
                          checkpoint_dir=cfg.checkpoint_dir,
                          checkpoint_name="run", log_every=1)
    out = capsys.readouterr().out
    assert "Iteration: 1 VLB" in out and "Validation reconstruction loss" in out
    assert trainer.host_step >= 3 and np.isfinite(metrics["loss"])
    assert np.isfinite(metrics["val_rec_loss"])
    model, vocab, report = ckpt.load_model(cfg.checkpoint_dir, "run",
                                           device="cpu")
    saved = ckpt.load_params(cfg.checkpoint_dir, "run")
    assert set(report.loaded) == set(saved) == set(before)
    assert any(np.abs(saved[k] - before[k]).max() > 0 for k in before)
    np.testing.assert_array_equal(
        model.encoder.q_heads.weight.detach().numpy(),
        saved["encoder/q_heads/kernel"].T)
    written = run_inference(cfg.replace(mode="inference"), model, vocab,
                            data.val_batcher(4), data.test_batcher(4),
                            output_dir=str(tmp_path))
    with open(written["val"]) as f:
        assert len(json.load(f)) == 2          # gen_val_captions holdout
    with open(written["test"]) as f:
        assert len(json.load(f)) == 4
    return cfg, data, before, saved


def test_fit_one_epoch_then_decode_the_checkpoint(mini_coco, tmp_path, capsys):
    _fit_then_decode(mini_coco, tmp_path, capsys)


def test_ag_fit_one_epoch_then_decode_the_checkpoint(mini_coco, tmp_path,
                                                     capsys):
    """The AG-CVAE with cluster vectors: the mini-COCO's instances files
    give every train and val image its cluster vector."""
    cfg, data, before, saved = _fit_then_decode(
        mini_coco, tmp_path, capsys, prior="AG", use_c_v=True)
    batch = next(data.train_batcher().train_batches(cfg.num_captions))
    assert batch.cluster_vectors.shape == (4, 90)
    assert np.allclose(batch.cluster_vectors.sum(axis=1), 1.0)
    assert saved["encoder/q_heads/kernel"].shape == (32, 2 * 90 * 8)
    for key in ("encoder/q_heads/kernel", "cv_emb/kernel"):
        assert np.abs(saved[key] - before[key]).max() > 0, key


def _cli_train(mini_coco, tmp_path, monkeypatch, *extra):
    cfg = _mini_cfg(mini_coco, tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["--mode", "training", "--coco_dir", mini_coco, "--device", "cpu",
            "--epochs", "1", "--bs", "4", "--checkpoint", "run",
            "--set", f"cache_dir={cfg.cache_dir}",
            "--set", f"checkpoint_dir={cfg.checkpoint_dir}",
            "--set", f"obj_vectors_dir={cfg.obj_vectors_dir}",
            "--set", "embed_size=32", "--set", "encoder_hidden=32",
            "--set", "decoder_hidden=32", "--set", "latent_size=8",
            "--set", "gen_z_samples=2", "--set", "num_ex_per_epoch=8",
            "--set", "gen_val_captions=2", *extra]
    # without a feature cache the CLI extracts with VGG16, whose weights
    # (the default ./vgg16_weights.npz) are missing here
    with pytest.raises(FileNotFoundError, match="vgg16_weights.npz"):
        tcli.main(argv)
    _feature_caches(mini_coco, cfg.cache_dir, ("train2014", "val2014"))
    tcli.main(argv)
    base = os.path.join(cfg.checkpoint_dir, "run")
    steps = ckpt.Checkpointer(cfg.checkpoint_dir, "run").all_steps()
    assert len(steps) == 1 and steps[0] >= 2      # the epoch's train state
    assert sorted(os.listdir(base)) == sorted(
        ["config.json", "params.npz", "vocab.json", str(steps[0])])
    model, vocab, _ = ckpt.load_model(cfg.checkpoint_dir, "run",
                                      device="cpu")
    assert model.encoder is not None and vocab.vocab_size > 3
    return cfg, model, vocab


def test_gmm_fit_one_epoch_then_decode_the_checkpoint(mini_coco, tmp_path,
                                                      capsys):
    """The GMM-CVAE with the flash CE; its checkpoint decodes with z
    centred at 0, as every prior but AG."""
    cfg, data, before, saved = _fit_then_decode(
        mini_coco, tmp_path, capsys, prior="GMM", fused_ce=True)
    assert saved["encoder/q_heads/kernel"].shape == (32, 2 * 90 * 8)
    for key in ("encoder/q_heads/kernel", "decoder/rnn_logits/kernel"):
        assert np.abs(saved[key] - before[key]).max() > 0, key


def test_cli_training_end_to_end(mini_coco, tmp_path, monkeypatch):
    _cli_train(mini_coco, tmp_path, monkeypatch)


def test_ag_cli_training_end_to_end(mini_coco, tmp_path, monkeypatch):
    """``--set prior=AG --set use_c_v=True`` trains the AG-CVAE; its
    checkpoint then decodes through ``--mode inference``."""
    cfg, model, _ = _cli_train(mini_coco, tmp_path, monkeypatch,
                               "--set", "prior=AG", "--set", "use_c_v=True")
    assert model.prior == "AG" and model.use_c_v
    _feature_caches(mini_coco, cfg.cache_dir, ("val2014", "test2014"))
    tcli.main(["--mode", "inference", "--coco_dir", mini_coco,
               "--checkpoint", "run", "--device", "cpu",
               "--set", f"checkpoint_dir={cfg.checkpoint_dir}",
               "--set", f"cache_dir={cfg.cache_dir}",
               "--set", f"obj_vectors_dir={cfg.obj_vectors_dir}",
               "--set", "gen_batch_size=4"])
    with open(tmp_path / "val_00.json") as f:
        assert len(json.load(f)) == 2          # the training run's holdout
    with open(tmp_path / "test_00.json") as f:
        assert len(json.load(f)) == 4


def test_gmm_fused_ce_cli_training_end_to_end(mini_coco, tmp_path,
                                             monkeypatch):
    """``--set prior=GMM --set fused_ce=True`` trains the GMM-CVAE through
    the flash CE; its checkpoint then decodes through ``--mode
    inference``."""
    cfg, model, _ = _cli_train(mini_coco, tmp_path, monkeypatch,
                               "--set", "prior=GMM", "--set", "fused_ce=True")
    assert model.prior == "GMM"
    _feature_caches(mini_coco, cfg.cache_dir, ("val2014", "test2014"))
    tcli.main(["--mode", "inference", "--coco_dir", mini_coco,
               "--checkpoint", "run", "--device", "cpu",
               "--set", f"checkpoint_dir={cfg.checkpoint_dir}",
               "--set", f"cache_dir={cfg.cache_dir}",
               "--set", f"obj_vectors_dir={cfg.obj_vectors_dir}",
               "--set", "gen_batch_size=4"])
    with open(tmp_path / "test_00.json") as f:
        assert len(json.load(f)) == 4


def test_gmm_hybrid_ce_cli_training_end_to_end(mini_coco, tmp_path,
                                              monkeypatch):
    """``--set prior=GMM --set ce_hybrid=True`` trains the GMM-CVAE through
    the hybrid CE (its plain twin on the CPU)."""
    _, model, _ = _cli_train(mini_coco, tmp_path, monkeypatch,
                             "--set", "prior=GMM", "--set", "ce_hybrid=True")
    assert model.prior == "GMM"


@pytest.mark.parametrize("override,item", [
    (dict(dec_lstm_drop=0.5), "A.11"),
    (dict(encoder_rnn_layers=2), "A.11"),
    (dict(decoder_rnn_layers=2), "A.11"),
    (dict(compute_dtype="float32"), "A.11"),
])
def test_uncovered_training_configurations_raise(override, item):
    cfg = _cfg(**override)
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        ttrain.check_supported_training(cfg)
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        ttrain.Trainer(cfg, device="cpu")


@pytest.mark.parametrize("flags", [dict(fused_ce=True, ce_hybrid=True),
                                   dict(fused_ce=True, ce_xla_bwd=True),
                                   dict(ce_hybrid=True, ce_xla_bwd=True)])
def test_more_than_one_ce_schedule_raises(flags):
    """The JAX package takes one of them by silent precedence; the port
    rejects the configuration."""
    with pytest.raises(ValueError, match="at most one CE schedule"):
        ttrain.check_supported_training(_cfg(**flags))


@pytest.mark.parametrize("use_c_v", [False, True])
def test_ag_prior_trains_with_and_without_c_v_steps(use_c_v):
    """prior='AG' is accepted with or without use_c_v: the cluster
    vectors always weight the heads, and feed the LSTMs' conditioning
    steps only with use_c_v."""
    cfg = _cfg(prior="AG", use_c_v=use_c_v, embed_size=32, encoder_hidden=32,
               decoder_hidden=32, latent_size=8, num_clusters=6)
    ttrain.check_supported_training(cfg)
    trainer = ttrain.Trainer(cfg, device="cpu")
    feats, enc, dec, lens = _batch(seed=8)
    cv = np.random.default_rng(8).dirichlet(np.ones(6), size=B)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.from_numpy(cv.astype(np.float32)))
    m = [trainer.run_step_arrays(arrays) for _ in range(3)]
    assert float(m[2]["loss"]) < float(m[0]["loss"])
    assert float(m[0]["kld"]) > 0 and np.isfinite(float(
        trainer.eval_step(*arrays, z_seed=1)))
    grad = trainer.model.cv_emb.weight.grad      # of the last step
    assert (grad is not None and bool(grad.abs().sum() > 0)) == use_c_v


def test_baseline_without_encoder_trains():
    cfg = _cfg(no_encoder=True, embed_size=32, decoder_hidden=32)
    trainer = ttrain.Trainer(cfg, device="cpu")
    feats, enc, dec, lens = _batch(seed=4)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    m = [trainer.run_step_arrays(arrays) for _ in range(3)]
    assert float(m[0]["kld"]) == 0.0
    assert float(m[2]["loss"]) < float(m[0]["loss"])


def test_caption_input_dropout():
    cfg = _cfg(dec_keep_rate=0.5, embed_size=32, encoder_hidden=32,
               decoder_hidden=32)
    trainer = ttrain.Trainer(cfg, device="cpu")
    assert trainer.dropout is not None
    feats, enc, dec, lens = _batch(seed=5)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    assert np.isfinite(float(trainer.run_step_arrays(arrays)["loss"]))
    model = trainer.model
    carry = model.decoder.lstm.zero_carry(B * K)
    args = (carry, torch.from_numpy(dec).long(), torch.from_numpy(lens))
    with torch.no_grad():
        a = model.decoder.teacher_forcing(*args)
        b = model.decoder.teacher_forcing(
            *args, dropout=torch.Generator().manual_seed(0))
        assert not torch.equal(a, b)
        assert torch.equal(a, model.decoder.teacher_forcing(*args))


# ----------------------------------------------------------------------
# debug_nans (the JAX CLI's jax_debug_nans)
# ----------------------------------------------------------------------

def _small_trainer(**kw):
    cfg = _cfg(embed_size=32, encoder_hidden=32, decoder_hidden=32, **kw)
    feats, enc, dec, lens = _batch(seed=7)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    return ttrain.Trainer(cfg, device="cpu"), arrays


@pytest.mark.parametrize("plant,quantity", [("weight", "loss"),
                                            ("grad_norm", "grad_norm")])
def test_debug_nans_raises_at_the_first_non_finite_value(plant, quantity):
    """A NaN planted in a weight makes the loss the first non-finite
    value; an infinite gradient norm (the optimizer's return replaced)
    is named when the loss is finite.  The message names the step."""
    trainer, arrays = _small_trainer(debug_nans=True)
    trainer.run_step_arrays(arrays)                 # step 0 is finite
    if plant == "weight":
        with torch.no_grad():
            trainer.model.decoder.rnn_logits.bias[3] = float("nan")
    else:
        step = trainer.optimizer.step
        trainer.optimizer.step = lambda grads: step(grads) * float("inf")
        trainer.train_step = ttrain.make_train_step(
            trainer.model, trainer.optimizer, trainer.cfg)
    with pytest.raises(FloatingPointError,
                       match=rf"debug_nans: {quantity} is (nan|inf) at step 1"):
        trainer.run_step_arrays(arrays)
    if plant == "weight":       # without the flag the step runs on
        off, _ = _small_trainer()
        off.model.load_state_dict(trainer.model.state_dict())
        assert not np.isfinite(float(off.run_step_arrays(arrays)["loss"]))


def test_debug_nans_off_adds_nothing_to_a_step():
    """With the flag off a step dispatches exactly the operations of the
    step function itself; with it on, the check adds its own."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def ops(fn) -> int:
        Count.n = 0
        with Count():
            fn()
        return Count.n

    counts = {}
    for name, flag in (("off", False), ("direct", False), ("on", True)):
        t, arrays = _small_trainer(debug_nans=flag)
        if name == "direct":
            counts[name] = ops(lambda: t.train_step(
                t.host_step, *arrays, z_seed=t.next_seed(), dropout=t.dropout,
                clusters=t.clusters, cnn_dropout=t.cnn_dropout))
        else:
            counts[name] = ops(lambda: t.run_step_arrays(arrays))
    assert counts["off"] == counts["direct"], counts
    assert counts["on"] > counts["off"], counts


def test_cli_debug_nans_turns_on_anomaly_detection(monkeypatch):
    seen = []
    monkeypatch.setattr(tcli, "run_training",
                        lambda cfg, device: seen.append(
                            (cfg.debug_nans, torch.is_anomaly_enabled())))
    try:
        tcli.main(["--mode", "training", "--device", "cpu",
                   "--set", "debug_nans=True"])
        tcli.main(["--mode", "training", "--device", "cpu"])
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert seen[0] == (True, True)
