"""The decode slice of the port against the JAX package, end to end:
``decode_init``, beam search at beam 3 (best and all beams), greedy
decoding, the int8 logits, the unfused step (``fused_decode=False``),
temperature sampling, ``run_inference``'s JSON files and the port's CLI.

The JAX side runs its fused decode path (``cfg.fused_force``) with the
Pallas kernels in interpret mode, so both sides compute f32 logits from
bf16 operands.  Both draw the same z noise: the JAX decoder's
``jax.random.normal`` is patched to return the numpy eps the port is
given.  The carry must agree to atol 1e-5, tokens exactly, and scores to
rtol 1e-5."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from flax.traverse_util import flatten_dict

from vae_captioning_tpu import inference as jinf
from vae_captioning_tpu.config import Config
from vae_captioning_tpu.data.batcher import CaptionBatcher
from vae_captioning_tpu.data.features import FeatureStore
from vae_captioning_tpu.data.vocabulary import Vocabulary
from vae_captioning_tpu.models.cvae import CVAEModel as JaxCVAE
from vae_captioning_tpu.train import init_model
from vae_captioning_torch import checkpoint as ckpt
from vae_captioning_torch import cli as tcli
from vae_captioning_torch import inference as tinf
from vae_captioning_torch.bridge import flax_shapes, load_flax_params
from vae_captioning_torch.models.cvae import CVAEModel, logits_head_params

B = 4          # images per decode batch


def _cfg(**kw):
    base = dict(embed_size=32, latent_size=16, encoder_hidden=32,
                decoder_hidden=32, gen_z_samples=4, prior="AG", use_c_v=True,
                gen_max_len=6, beam_size=3, compute_dtype="bfloat16")
    base.update(kw)
    cfg = Config(**base)
    cfg.vocab_size = 64
    cfg.fused_force = True          # JAX: fused decode kernels on the CPU
    return cfg


VOCAB = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(60)])


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    _, params = init_model(cfg, jax.random.PRNGKey(0))
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    model = CVAEModel.from_config(cfg)
    load_flax_params(model, flat)
    return cfg, params, flat, model


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, 4096)).astype(np.float32)
    c_v = (rng.random((B, 90)) * (rng.random((B, 90)) < 0.1)).astype(np.float32)
    c_v[0] = 0.0                     # no detection: the AG fallback mean
    eps = rng.normal(size=(B, 32)).astype(np.float32)
    return feats, c_v, eps


def _patch_eps(monkeypatch, eps):
    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps.shape
        return jnp.asarray(eps, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


def test_decode_init_carry_matches_jax(models, monkeypatch):
    cfg, params, _, model = models
    feats, c_v, eps = _inputs()
    _patch_eps(monkeypatch, eps)
    jm = JaxCVAE.from_config(cfg)
    ((jc, jh),) = jm.apply({"params": params}, jnp.asarray(feats),
                           jnp.asarray(c_v), rngs={"z": jax.random.PRNGKey(1)},
                           method=JaxCVAE.decode_init)
    with torch.no_grad():
        ((c, h),) = model.decode_init(torch.from_numpy(feats),
                                      torch.from_numpy(c_v),
                                      eps=torch.from_numpy(eps))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)


def test_decode_steps_match_jax(models):
    """decode_step (bf16 logits head) and decode_step_hidden."""
    cfg, params, _, model = models
    rng = np.random.default_rng(3)
    c = rng.normal(size=(B, 32)).astype(np.float32)
    h = rng.normal(size=(B, 32)).astype(np.float32)
    tokens = np.array([1, 5, 17, 63], np.int32)
    jm = JaxCVAE.from_config(cfg)
    carry = ((jnp.asarray(c), jnp.asarray(h)),)
    tcarry = ((torch.from_numpy(c), torch.from_numpy(h)),)
    (_, jl) = jm.apply({"params": params}, carry, jnp.asarray(tokens),
                       method=JaxCVAE.decode_step)
    (((jc, jh),), jhid) = jm.apply({"params": params}, carry,
                                   jnp.asarray(tokens),
                                   method=JaxCVAE.decode_step_hidden)
    with torch.no_grad():
        _, logits = model.decode_step(tcarry, torch.from_numpy(tokens).long())
        ((tc, th),), hid = model.decode_step_hidden(
            tcarry, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), atol=1e-5, rtol=0)
    # bf16-rounded logits: one bf16 ulp apart at most
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["beam_search", "beam_search_all", "greedy"])
def test_decode_fns_match_jax_fused_decode(models, interpreted, monkeypatch,
                                           name):
    cfg, params, _, model = models
    feats, c_v, eps = _inputs(seed=1)
    _patch_eps(monkeypatch, eps)
    jfn = jinf.make_decode_fns(JaxCVAE.from_config(cfg), cfg, VOCAB)[name]
    want = jfn(params, jnp.asarray(feats), jnp.asarray(c_v),
               jax.random.PRNGKey(2))
    got = tinf.make_decode_fns(model, cfg, VOCAB)[name](
        torch.from_numpy(feats), torch.from_numpy(c_v),
        eps=torch.from_numpy(eps))
    want_tokens = want[0] if isinstance(want, tuple) else want
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want_tokens))
    if name != "greedy":
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want[1]),
                                   rtol=1e-5)
    assert 1 <= got.steps <= cfg.gen_max_len


@pytest.mark.parametrize("name", ["beam_search", "beam_search_all"])
def test_wide_beam_decode_matches_jax(models, interpreted, monkeypatch, name):
    """Beam 20, past the fused kernels' lists of 16 (on the card the
    fused decode then writes its logits and takes the top-k + logsumexp
    kernel): the plain decode against the JAX fused decode."""
    cfg, params, _, model = models
    cfg = cfg.replace(beam_size=20)
    feats, c_v, eps = _inputs(seed=4)
    _patch_eps(monkeypatch, eps)
    jfn = jinf.make_decode_fns(JaxCVAE.from_config(cfg), cfg, VOCAB)[name]
    want = jfn(params, jnp.asarray(feats), jnp.asarray(c_v),
               jax.random.PRNGKey(2))
    got = tinf.make_decode_fns(model, cfg, VOCAB, ops=tinf.PLAIN_OPS)[name](
        torch.from_numpy(feats), torch.from_numpy(c_v),
        eps=torch.from_numpy(eps))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want[1]),
                               rtol=1e-5)
    if name == "beam_search_all":
        assert got.tokens.shape[:2] == (B, 20)


def test_decode_weights_store_the_head_transposed(models):
    """The decode casts its bf16 head once per build, column-major:
    ``head_w.t()`` is W^T [V, H] contiguous, the layout the logits kernels
    read, with the values of the model's head."""
    cfg, _, _, model = models
    weights = tinf.DecodeWeights.of(model)
    w, _ = logits_head_params(model)
    assert weights.head_w.shape == (cfg.decoder_hidden, cfg.vocab_size)
    assert weights.head_w.dtype == torch.bfloat16
    assert weights.head_w.t().is_contiguous()
    assert not weights.head_w.is_contiguous()
    assert torch.equal(weights.head_w, w.detach().to(torch.bfloat16))
    int8 = tinf.DecodeWeights.of(model, int8=True)
    assert int8.head_wq.t().is_contiguous()


@pytest.mark.parametrize("name", ["beam_search", "greedy", "sample",
                                  "unfused"])
def test_decode_from_the_stored_head_equals_a_row_major_head(
        models, monkeypatch, name):
    """A decode from the stored (column-major) head equals, token for
    token and score for score, one from the same head made row-major: the
    decode steps and the plain versions take either layout."""
    cfg, _, _, model = models
    if name == "sample":
        cfg = cfg.replace(sample_gen="sample")
    elif name == "unfused":
        cfg, name = cfg.replace(fused_decode=False), "beam_search"
    feats, c_v, eps = _inputs(seed=4)
    args = (torch.from_numpy(feats), torch.from_numpy(c_v))
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    stored = tinf.make_decode_fns(model, cfg, VOCAB)[name](
        *args, eps=torch.from_numpy(eps), generator=gen())
    of = tinf.DecodeWeights.of

    def row_major(model, int8=False, **layout):
        weights = of(model, int8, **layout)
        assert not weights.head_w.is_contiguous()
        return weights._replace(head_w=weights.head_w.contiguous())

    monkeypatch.setattr(tinf.DecodeWeights, "of", row_major)
    rows = tinf.make_decode_fns(model, cfg, VOCAB)[name](
        *args, eps=torch.from_numpy(eps), generator=gen())
    assert torch.equal(stored.tokens, rows.tokens)
    if stored.scores is not None:
        assert torch.equal(stored.scores, rows.scores)


def _batchers(seed, n_val=7, n_test=5):
    rng = np.random.default_rng(seed)
    out = []
    for split, n in (("val", n_val), ("test", n_test)):
        names = [f"COCO_{split}_{i:04d}.jpg" for i in range(n)]
        store = FeatureStore(names, rng.normal(size=(n, 4096)))
        c_v = {nm: (rng.random(91) * (rng.random(91) < 0.1)).astype(np.float32)
               for nm in names[1:]}       # names[0]: the zero fallback
        caps = {nm: [[VOCAB.bos_id, 5, 9, VOCAB.eos_id]] for nm in names}
        out.append((names, store, c_v, caps))

    def make():
        (vn, vs, vc, vcap), (tn, ts, tc, _) = out
        val = CaptionBatcher(vn, vcap, B, feature_store=vs, cluster_vectors=vc,
                             filename_to_imid={n: 100 + i
                                               for i, n in enumerate(vn)})
        test = CaptionBatcher(tn, {}, B, feature_store=ts, cluster_vectors=tc,
                              filename_to_imid={n: 200 + i
                                                for i, n in enumerate(tn)})
        return val, test

    return make


def test_run_inference_json_matches_jax(models, interpreted, tmp_path):
    """std = 0 takes the noise out of z, so both sides decode the same
    carry whatever their random streams."""
    cfg, params, _, model = models
    cfg = cfg.replace(std=0.0)
    make = _batchers(seed=4)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    j_paths = jinf.run_inference(cfg, params, VOCAB, *make(),
                                 output_dir=str(tmp_path / "jax"))
    stats = {}
    t_model = CVAEModel.from_config(cfg)
    t_model.load_state_dict(model.state_dict())
    t_paths = tinf.run_inference(cfg, t_model, VOCAB, *make(),
                                 output_dir=str(tmp_path / "torch"),
                                 stats=stats)
    assert set(j_paths) == set(t_paths) == {"val", "test"}
    for split in ("val", "test"):
        with open(j_paths[split]) as f:
            want = json.load(f)
        with open(t_paths[split]) as f:
            got = json.load(f)
        assert got == want
        assert len(got) == (7 if split == "val" else 5)
    assert stats["val"]["batches"] == 2 and stats["val"]["cv_fallbacks"] == 1
    assert 2 <= stats["test"]["decode_steps"] <= 2 * cfg.gen_max_len


@pytest.mark.parametrize("override,item", [
    (dict(decoder_rnn_layers=2), "A.11"),
    (dict(compute_dtype="float32"), "A.11"),
])
def test_uncovered_configurations_raise(models, override, item):
    """These configurations raised NotImplementedError until ROADMAP
    ``item`` ported them: a model built for them now decodes (tokens of
    the batch's shape); an unknown compute dtype still raises
    ValueError."""
    cfg, _, _, _ = models
    cfg = cfg.replace(**override)
    model = CVAEModel.from_config(cfg)
    feats, c_v, eps = _inputs(seed=2)
    res = tinf.make_decode_fns(model, cfg, VOCAB)["beam_search"](
        torch.from_numpy(feats), torch.from_numpy(c_v),
        eps=torch.from_numpy(eps))
    assert res.tokens.shape == (B, cfg.gen_max_len), item
    with pytest.raises(ValueError):
        tinf.make_decode_fns(model, cfg.replace(compute_dtype="float16"),
                             VOCAB)


@pytest.mark.parametrize("name", ["beam_search", "beam_search_all", "greedy"])
def test_int8_decode_matches_jax(models, interpreted, monkeypatch, name):
    """``decode_int8``: both sides quantise the f32 head once and the f32
    h of each step per row; the JAX side runs its int8 Pallas kernel in
    interpret mode.  Tokens equal, scores to rtol 1e-5."""
    cfg, params, _, model = models
    cfg = cfg.replace(decode_int8=True)
    feats, c_v, eps = _inputs(seed=5)
    _patch_eps(monkeypatch, eps)
    jfn = jinf.make_decode_fns(JaxCVAE.from_config(cfg), cfg, VOCAB)[name]
    want = jfn(params, jnp.asarray(feats), jnp.asarray(c_v),
               jax.random.PRNGKey(2))
    got = tinf.make_decode_fns(model, cfg, VOCAB)[name](
        torch.from_numpy(feats), torch.from_numpy(c_v),
        eps=torch.from_numpy(eps))
    want_tokens = want[0] if isinstance(want, tuple) else want
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want_tokens))
    if name != "greedy":
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want[1]),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["beam_search", "beam_search_all", "greedy"])
def test_unfused_decode_matches_jax(models, monkeypatch, name):
    """``fused_decode=False``: the JAX side's step writes bf16 logits
    through its Flax Dense and takes XLA's top-k; the port's writes the
    same rounding and takes ``top_k_logsumexp``.  Tokens equal; scores to
    rtol 1e-5 (the logsumexp is an f32 sum in another order)."""
    cfg, params, _, model = models
    cfg = cfg.replace(fused_decode=False)
    feats, c_v, eps = _inputs(seed=6)
    _patch_eps(monkeypatch, eps)
    jfn = jinf.make_decode_fns(JaxCVAE.from_config(cfg), cfg, VOCAB)[name]
    want = jfn(params, jnp.asarray(feats), jnp.asarray(c_v),
               jax.random.PRNGKey(2))
    got = tinf.make_decode_fns(model, cfg, VOCAB)[name](
        torch.from_numpy(feats), torch.from_numpy(c_v),
        eps=torch.from_numpy(eps))
    want_tokens = want[0] if isinstance(want, tuple) else want
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want_tokens))
    if name != "greedy":
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want[1]),
                                   rtol=1e-5)


@pytest.mark.parametrize("override", [
    dict(decode_int8=True), dict(sample_gen="sample"),
    dict(sample_gen="sample", fused_decode=False),
    dict(decode_int8=True, fused_decode=False)],
    ids=["int8", "sample", "sample-unfused", "int8-unfused"])
def test_decode_modes_build_and_run(models, override):
    """The configurations ROADMAP B.6 and B.8 used to gate build and
    decode: tokens in range, PAD after EOS, the same tokens from the same
    generator seed."""
    cfg, _, _, model = models
    cfg = cfg.replace(**override)
    tinf.check_supported(cfg)
    fn = tinf.make_decode_fns(model, cfg, VOCAB)[cfg.sample_gen]
    feats, c_v, _ = _inputs(seed=7)
    runs = [fn(torch.from_numpy(feats), torch.from_numpy(c_v),
               generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    tokens = runs[0].tokens.numpy()
    assert tokens.shape[0] == B and tokens.shape[-1] == cfg.gen_max_len
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    np.testing.assert_array_equal(tokens, runs[1].tokens.numpy())
    for row in tokens.reshape(-1, cfg.gen_max_len):
        ends = np.flatnonzero(row == VOCAB.eos_id)
        if ends.size:
            assert not row[ends[0] + 1:].any()


def test_sample_decode_depends_on_the_generator(models):
    cfg, _, _, model = models
    fn = tinf.make_decode_fns(model, cfg.replace(sample_gen="sample",
                                                 temperature=1.5), VOCAB)["sample"]
    feats, c_v, eps = _inputs(seed=8)
    args = (torch.from_numpy(np.repeat(feats, 8, 0)),
            torch.from_numpy(np.repeat(c_v, 8, 0)))
    eps = torch.from_numpy(np.repeat(eps, 8, 0))
    a, b = (fn(*args, eps=eps, generator=torch.Generator().manual_seed(s))
            for s in (1, 2))
    assert not torch.equal(a.tokens, b.tokens)


def test_run_inference_sample_writes_both_files(models, interpreted, tmp_path):
    """``sample_gen="sample"``: the val split is sampled through the
    sampler (plain version on the CPU), the test split is greedy and
    equals the JAX package's (std = 0 takes the noise out of z)."""
    cfg, params, _, model = models
    cfg = cfg.replace(std=0.0, sample_gen="sample", gen_name="sampled")
    make = _batchers(seed=9)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    # the JAX sampler's TPU PRNG has no CPU lowering: its greedy test
    # split alone is the reference
    j_paths = jinf.run_inference(cfg.replace(sample_gen="greedy"), params,
                                 VOCAB, *make(),
                                 output_dir=str(tmp_path / "jax"))
    stats = {}
    t_model = CVAEModel.from_config(cfg)        # decode_std = cfg.std
    t_model.load_state_dict(model.state_dict())
    t_paths = tinf.run_inference(cfg, t_model, VOCAB, *make(),
                                 output_dir=str(tmp_path / "torch"),
                                 stats=stats)
    assert sorted(os.listdir(tmp_path / "torch")) == [
        "test_sampled.json", "val_sampled.json"]
    with open(t_paths["val"]) as f:
        val = json.load(f)
    assert sorted(c["image_id"] for c in val) == list(range(100, 107))
    assert all(isinstance(c["caption"], str) for c in val)
    with open(j_paths["test"]) as f:
        want = json.load(f)
    with open(t_paths["test"]) as f:
        assert json.load(f) == want
    assert stats["val"]["batches"] == 2
    assert 2 <= stats["val"]["decode_steps"] <= 2 * cfg.gen_max_len


def test_cli_inference_on_mini_coco(models, mini_coco, tmp_path, monkeypatch,
                                   capsys):
    """The port's CLI restores a checkpoint and writes both JSON files
    from feature caches; without a cache it extracts with VGG16, whose
    weights file is missing here.  Then ``--restore`` resumes a training
    run: with no train state it starts afresh, then it resumes from the
    newest one."""
    from vae_captioning_tpu.data.dataset import Data
    cfg = models[0]
    cache = tmp_path / "cache"
    run_cfg = cfg.replace(coco_dir=mini_coco, cache_dir=str(cache),
                          obj_vectors_dir=str(tmp_path / "obj"),
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          checkpoint="run", gen_batch_size=4, hdf5_file="",
                          raw_images_file="")
    data = Data(run_cfg.replace(), extract_features=False)
    ckpt.save_sidecars(run_cfg.replace(vocab_size=data.vocab.vocab_size),
                       data.vocab, run_cfg.checkpoint_dir, "run")
    model = CVAEModel.from_config(
        run_cfg.replace(vocab_size=data.vocab.vocab_size))
    rng = np.random.default_rng(0)
    params = {k: rng.normal(0, 0.2, size=shape).astype(np.float32)
              for k, shape in flax_shapes(model).items()}
    ckpt.save_params(params, run_cfg.checkpoint_dir, "run")
    monkeypatch.chdir(tmp_path)
    argv = ["--mode", "inference", "--coco_dir", mini_coco,
            "--checkpoint", "run", "--device", "cpu",
            "--set", f"checkpoint_dir={run_cfg.checkpoint_dir}",
            "--set", "gen_batch_size=4"]
    with pytest.raises(FileNotFoundError, match="vgg16_weights.npz"):
        tcli.main(argv)
    for split in ("val2014", "test2014"):
        files = sorted(os.listdir(os.path.join(mini_coco, "images", split)))
        FeatureStore(files, rng.normal(size=(len(files), 4096))).save(
            str(cache / f"{split}.features.npz"))
    tcli.main(argv)
    with open(tmp_path / "val_00.json") as f:
        val = json.load(f)
    with open(tmp_path / "test_00.json") as f:
        test = json.load(f)
    assert len(val) == 6 and len(test) == 4
    assert all(isinstance(c["caption"], str) for c in val + test)
    files = sorted(os.listdir(os.path.join(mini_coco, "images", "train2014")))
    FeatureStore(files, rng.normal(size=(len(files), 4096))).save(
        str(cache / "train2014.features.npz"))
    train = ["--mode", "training", "--coco_dir", mini_coco, "--device", "cpu",
             "--restore", "--epochs", "1", "--bs", "4", "--checkpoint", "resume",
             "--set", f"checkpoint_dir={run_cfg.checkpoint_dir}",
             "--set", f"cache_dir={cache}",
             "--set", f"obj_vectors_dir={run_cfg.obj_vectors_dir}",
             "--set", "prior=AG", "--set", "use_c_v=True",
             "--set", "embed_size=32", "--set", "encoder_hidden=32",
             "--set", "decoder_hidden=32", "--set", "latent_size=8",
             "--set", "gen_z_samples=2", "--set", "num_ex_per_epoch=8",
             "--set", "gen_val_captions=2"]
    states = ckpt.Checkpointer(run_cfg.checkpoint_dir, "resume")
    tcli.main(train)
    first = states.latest_step()
    assert first is not None
    capsys.readouterr()
    tcli.main(train)
    assert f"Restoring from checkpoint step {first}" in capsys.readouterr().out
    assert states.all_steps() == [first, 2 * first]
