"""Flax parameters → port modules (vae_captioning_torch/bridge.py), and
the port's checkpoint files built on it."""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from vae_captioning_tpu.config import Config
from vae_captioning_tpu.data.vocabulary import Vocabulary
from vae_captioning_tpu.train import init_model
from vae_captioning_torch import checkpoint as ckpt
from vae_captioning_torch.bridge import (export_flax_params, flax_shapes,
                                         load_flax_params)
from vae_captioning_torch.models.cvae import CVAEModel


def _cfg(**kw):
    base = dict(embed_size=32, latent_size=16, encoder_hidden=32,
                decoder_hidden=32, gen_z_samples=4, prior="AG", use_c_v=True,
                gen_max_len=6, compute_dtype="bfloat16")
    base.update(kw)
    cfg = Config(**base)
    cfg.vocab_size = 64
    return cfg


def _flax_params(cfg, seed=0):
    _, params = init_model(cfg, jax.random.PRNGKey(seed))
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def ag_params():
    cfg = _cfg()
    return cfg, _flax_params(cfg)


def test_every_decode_leaf_is_consumed_with_its_layout(ag_params):
    cfg, flat = ag_params
    model = CVAEModel.from_config(cfg)
    report = load_flax_params(model, flat)
    assert set(report.loaded) == set(flat)
    p = dict(model.named_parameters())
    dense = {"imf_emb": "imf_emb", "cv_emb": "cv_emb",
             "decoder/z_rnn": "decoder.z_rnn",
             "decoder/rnn_logits": "decoder.rnn_logits"}
    for flax_name, torch_name in dense.items():
        # Flax Dense kernels are [in, out]; nn.Linear weights [out, in]
        np.testing.assert_array_equal(p[f"{torch_name}.weight"].detach().numpy(),
                                      flat[f"{flax_name}/kernel"].T)
        np.testing.assert_array_equal(p[f"{torch_name}.bias"].detach().numpy(),
                                      flat[f"{flax_name}/bias"])
    # the LSTM keeps its [E+H, 4H] kernel, x rows first; embeddings as is
    np.testing.assert_array_equal(
        p["decoder.lstm.cells.0.kernel"].detach().numpy(),
        flat["decoder/lstm/cell_0/kernel"])
    np.testing.assert_array_equal(
        p["decoder.lstm.cells.0.bias"].detach().numpy(),
        flat["decoder/lstm/cell_0/bias"])
    np.testing.assert_array_equal(
        p["decoder.dec_embeddings.weight"].detach().numpy(),
        flat["decoder/dec_embeddings/embedding"])
    assert {k: v.shape for k, v in flat.items()} == \
        flax_shapes(model)


def test_encoder_leaves_are_listed_as_pending(ag_params):
    """Nothing is left pending any more: every encoder leaf, the AG
    q_heads [H, 2·90·L] included, loads into the port's encoder."""
    cfg, flat = ag_params
    model = CVAEModel.from_config(cfg)
    report = load_flax_params(model, flat)
    assert not hasattr(report, "pending")
    enc_keys = {k for k in flat if k.startswith("encoder/")}
    assert enc_keys and enc_keys <= set(report.loaded)
    assert flat["encoder/q_heads/kernel"].shape == (32, 2 * 90 * 16)
    np.testing.assert_array_equal(
        model.encoder.q_heads.weight.detach().numpy(),
        flat["encoder/q_heads/kernel"].T)
    np.testing.assert_array_equal(
        model.encoder.lstm.cells[0].kernel.detach().numpy(),
        flat["encoder/lstm/cell_0/kernel"])


def test_nested_tree_loads_like_the_flat_one(ag_params):
    cfg, flat = ag_params
    nested = {}
    for key, value in flat.items():
        node = nested
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    a, b = CVAEModel.from_config(cfg), CVAEModel.from_config(cfg)
    load_flax_params(a, flat)
    load_flax_params(b, nested)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na


@pytest.mark.parametrize("variant", [
    dict(prior="Normal", use_c_v=False),      # no cv_emb
    dict(no_encoder=True, prior="Normal"),    # no z_rnn
])
def test_variants_match_their_flax_trees(variant):
    cfg = _cfg(**variant)
    flat = _flax_params(cfg, seed=1)
    model = CVAEModel.from_config(cfg)
    report = load_flax_params(model, flat)
    assert set(report.loaded) == set(flax_shapes(model))


def test_unknown_key_raises(ag_params):
    cfg, flat = ag_params
    bad = dict(flat, **{"decoder/extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unknown Flax parameter"):
        load_flax_params(CVAEModel.from_config(cfg), bad)


def test_misshaped_key_raises(ag_params):
    cfg, flat = ag_params
    bad = dict(flat)
    bad["decoder/rnn_logits/kernel"] = flat["decoder/rnn_logits/kernel"].T
    with pytest.raises(ValueError, match="rnn_logits/kernel.*shape"):
        load_flax_params(CVAEModel.from_config(cfg), bad)


def test_missing_key_raises(ag_params):
    cfg, flat = ag_params
    bad = {k: v for k, v in flat.items() if k != "cv_emb/bias"}
    with pytest.raises(ValueError, match="missing.*cv_emb/bias"):
        load_flax_params(CVAEModel.from_config(cfg), bad)


def test_checkpoint_round_trip(ag_params, tmp_path):
    cfg, flat = ag_params
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(60)])
    ckpt.save_sidecars(cfg, vocab, str(tmp_path), "run")
    ckpt.save_params(flat, str(tmp_path), "run")
    model, vocab2, report = ckpt.load_model(str(tmp_path), "run",
                                            device="cpu")
    assert vocab2.idx2word == vocab.idx2word
    assert set(report.loaded) == set(flat)
    np.testing.assert_array_equal(
        model.decoder.rnn_logits.weight.detach().numpy(),
        flat["decoder/rnn_logits/kernel"].T)


def test_checkpoint_vocab_mismatch_raises(ag_params, tmp_path):
    cfg, flat = ag_params
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>", "a"])
    ckpt.save_sidecars(cfg, vocab, str(tmp_path), "run")
    ckpt.save_params(flat, str(tmp_path), "run")
    with pytest.raises(ValueError, match="vocab"):
        ckpt.load_model(str(tmp_path), "run", device="cpu")


@pytest.mark.parametrize("variant", [
    dict(prior="Normal", use_c_v=False),
    dict(prior="Normal", use_c_v=True),
    dict(prior="GMM", use_c_v=True),
    dict(prior="AG", use_c_v=True),
    dict(no_encoder=True, prior="Normal"),
])
def test_every_prior_loads_fully_and_exports_back(variant):
    """A full Flax tree of each prior loads with every key consumed, and
    export_flax_params gives the same tree back, key for key and bit for
    bit."""
    cfg = _cfg(**variant)
    flat = _flax_params(cfg, seed=2)
    model = CVAEModel.from_config(cfg)
    report = load_flax_params(model, flat)
    assert sorted(report.loaded) == sorted(flat)
    back = export_flax_params(model)
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    again = CVAEModel.from_config(cfg)
    load_flax_params(again, back)
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(a, b), name
