"""VGG16 and fine-tuning in the port (models/vgg16.py, models/finetune.py,
train.make_finetune_optimizer, the fine-tune train step and decode, the
image stores and the feature extractor) against the JAX package.

VGG16 runs at 32x32 (fc1 then reads 512 inputs; the module is the same
at every size) against the Flax VGG16 on the same numpy weights and
images: f32 to 1e-4 and bf16 to 2e-2 of the largest output.  The
Caffe-npz loader and the extractor run at 224 on the ``vgg_npz``
fixture.  The fine-tune model's forward, loss and a 3-step trajectory
follow the JAX ``FineTuneModel`` with its CVAE on the kernel path in
interpret mode (widths of 128, the explicit eps of
tests/test_torch_train.py); the optimizer follows optax's
``multi_transform`` update for update."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from test_torch_train import _eps, _ops, interpreted  # noqa: F401
from vae_captioning_tpu import train as jtrain
from vae_captioning_tpu.config import Config as JConfig
from vae_captioning_tpu.data import images as jimages
from vae_captioning_tpu.data import native_loader as jnative
from vae_captioning_tpu.models.cvae import compute_loss as j_compute_loss
from vae_captioning_tpu.models.vgg16 import VGG16 as JVGG16
from vae_captioning_tpu.models.vgg16 import load_npz_weights as j_load_npz
from vae_captioning_torch import train as ttrain
from vae_captioning_torch.bridge import (export_flax_params, flax_shapes,
                                         from_flax_array, load_flax_params)
from vae_captioning_torch.checkpoint import Checkpointer
from vae_captioning_torch.config import Config
from vae_captioning_torch.data import dataset as tdataset
from vae_captioning_torch.data import images as timages
from vae_captioning_torch.data import native_loader as tnative
from vae_captioning_torch.data.features import (FeatureExtractor,
                                                extract_features_from_dir)
from vae_captioning_torch.data.vocabulary import Vocabulary
from vae_captioning_torch.inference import make_decode_fns
from vae_captioning_torch.models.cvae import compute_loss
from vae_captioning_torch.models.finetune import (FineTuneModel, cvae_of,
                                                  load_vgg_into_params)
from vae_captioning_torch.models.vgg16 import (IMAGENET_MEAN, VGG16,
                                               load_npz_weights)

S = 32                # image side: 13 convs, 5 pools, a 512-wide fc1
B, K, T, V = 2, 3, 6, 50
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
# the fine-tune model's metrics: its CVAE reads the bf16 VGG16's fc2
# features, which agree to VGG16's bf16 tolerance (2e-2), not to the
# feature-fed CVAE's METRIC_RTOL (measured: 0.47% on the kld of step 2)
FT_RTOL = 2e-2


def _flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(tree)).items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _images(n=2, seed=0, size=S, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3)).astype(dtype)


@pytest.fixture(scope="module")
def flax_vgg():
    model = JVGG16(compute_dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    return _flat(params["params"])


@pytest.mark.parametrize("input_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vgg16_matches_flax(flax_vgg, dtype, input_dtype):
    t_dtype, j_dtype, tol = DTYPES[dtype]
    images = _images(dtype=input_dtype)
    want = JVGG16(compute_dtype=j_dtype).apply(
        {"params": _nest(flax_vgg)}, jnp.asarray(images))
    model = VGG16(compute_dtype=t_dtype, image_size=S)
    load_flax_params(model, flax_vgg)
    got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (2, 4096)
    assert _rel(got.detach(), want) <= tol
    assert bool((got >= 0).all())          # fc2 is post-ReLU


def test_vgg16_bridge_round_trip_and_layouts(flax_vgg):
    model = VGG16(image_size=S)
    load_flax_params(model, flax_vgg)
    assert model.conv1_1.weight.shape == (64, 3, 3, 3)          # OIHW
    np.testing.assert_array_equal(
        model.conv1_2.weight.detach().numpy(),
        flax_vgg["conv1_2/kernel"].transpose(3, 2, 0, 1))
    assert flax_shapes(model)["conv1_1/kernel"] == (3, 3, 3, 64)  # HWIO
    out = export_flax_params(model)
    assert set(out) == set(flax_vgg)
    for key, value in flax_vgg.items():
        np.testing.assert_array_equal(out[key], value)


def test_vgg16_subtracts_the_mean_in_f32():
    """The ImageNet mean with all-zero weights gives zero; uint8 pixels do
    not wrap (255 - 123.68 stays positive)."""
    model = VGG16(compute_dtype=torch.float32, image_size=S)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    mean = torch.tensor(IMAGENET_MEAN).expand(1, S, S, 3)
    assert bool((model(mean) == 0).all())
    white = torch.full((1, S, S, 3), 255, dtype=torch.uint8)
    x = white.float() - model.mean
    assert bool((x > 0).all())


def test_vgg16_dropout_only_when_trainable_and_given_a_generator(flax_vgg):
    images = torch.from_numpy(_images())
    model = VGG16(compute_dtype=torch.float32, dropout_keep=0.5,
                  trainable_top=True, image_size=S)
    load_flax_params(model, flax_vgg)
    plain = model(images)
    a = model(images, torch.Generator().manual_seed(1))
    b = model(images, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    model.trainable_top = False
    assert torch.equal(model(images, torch.Generator().manual_seed(1)), plain)


def test_load_npz_weights_matches_the_jax_loader(vgg_npz):
    got, want = load_npz_weights(vgg_npz), j_load_npz(vgg_npz)
    assert set(got) == set(want) and "fc8" not in got
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf], want[name][leaf])
    model = VGG16()
    load_flax_params(model, got)
    assert model.fc1.weight.shape == (4096, 25088)
    flat = load_vgg_into_params({"cvae/imf_emb/bias": np.zeros(3)}, vgg_npz)
    assert flat["cvae/imf_emb/bias"].shape == (3,)
    np.testing.assert_array_equal(flat["vgg16/fc2/kernel"],
                                  want["fc2"]["kernel"])


def test_feature_extractor_matches_flax_and_caches(vgg_npz, mini_coco,
                                                   tmp_path):
    """At 224 on the npz weights: the port's fc2 against the Flax VGG16
    (f32), the last batch padded; then a directory's features cached."""
    images = _images(n=3, size=224)
    extract = FeatureExtractor(vgg_npz, batch_size=2,
                               compute_dtype="float32", device="cpu")
    got = extract(images)
    want = JVGG16(compute_dtype=jnp.float32).apply(
        {"params": j_load_npz(vgg_npz)}, jnp.asarray(images))
    assert got.shape == (3, 4096)
    assert _rel(got, want) <= 1e-4
    split_dir = os.path.join(mini_coco, "images", "test2014")
    store = extract_features_from_dir(split_dir, vgg_npz, str(tmp_path),
                                      batch_size=4, compute_dtype="float32",
                                      device="cpu")
    names = sorted(os.listdir(split_dir))
    assert store.names == names and store.features.shape == (4, 4096)
    loaded = timages.load_image_batch(
        [os.path.join(split_dir, n) for n in names[:2]])
    np.testing.assert_allclose(store.features[:2], extract(loaded),
                               rtol=1e-5, atol=1e-6)
    cached = extract_features_from_dir(split_dir, "missing.npz",
                                       str(tmp_path))
    np.testing.assert_array_equal(cached.features, store.features)


# ------------------------------------------------------------------ model

def _ft_cfg(cls=Config, **kw):
    base = dict(embed_size=128, encoder_hidden=128, decoder_hidden=128,
                latent_size=16, gen_z_samples=4, prior="Normal",
                compute_dtype="bfloat16", fine_tune=True, image_size=S,
                image_net_weights_path="/nonexistent.npz", mode="inference")
    base.update(kw)
    cfg = cls(**base)
    cfg.vocab_size = V
    cfg.fused_force = True
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
    return _images(seed=seed), enc, dec, lens


@pytest.fixture(scope="module")
def jax_finetune():
    cfg = _ft_cfg(JConfig)
    model, params = jtrain.init_model(cfg.replace(fused_force=False),
                                      jax.random.PRNGKey(0))
    return cfg, jtrain.build_model(cfg), params, _flat(params)


def test_finetune_forward_and_loss_match_jax(interpreted, jax_finetune):
    jcfg, model, params, flat = jax_finetune
    images, enc, dec, lens = _batch()
    out = model.apply({"params": params}, jnp.asarray(images),
                      jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(lens),
                      None, rngs={"z": jax.random.PRNGKey(3)},
                      time_major=True)
    j_loss = j_compute_loss(out, jnp.asarray(enc).T, prior="Normal",
                            no_encoder=False, annealing=1.0, time_major=True)
    cfg = _ft_cfg()
    t_model = FineTuneModel.from_config(cfg)
    load_flax_params(t_model, flat)
    t_out = t_model(torch.from_numpy(images), torch.from_numpy(enc).long(),
                    torch.from_numpy(dec).long(), torch.from_numpy(lens),
                    ops=_ops(_eps(cfg)), time_major=True)
    t_loss = compute_loss(t_out, torch.from_numpy(enc).long().t(),
                          no_encoder=False, annealing=1.0)
    for key in ("q_mean", "q_std"):
        assert _rel(t_out[key].detach(), out[key]) <= 2e-2, key
    np.testing.assert_allclose(t_out["logits"].float().detach().numpy(),
                               np.asarray(out["logits"], np.float32),
                               rtol=2e-2, atol=2e-2)
    for key in ("loss", "rec_loss", "kld"):
        np.testing.assert_allclose(float(t_loss[key].detach()),
                                   float(j_loss[key]), rtol=FT_RTOL,
                                   err_msg=key)


def test_finetune_three_train_steps_match_jax(interpreted, jax_finetune):
    """VGG16's dropout is off (``mode="inference"`` keeps every unit, as
    the JAX model does), so both steps are deterministic.  The CNN chain
    runs at the reference's cnn_lr (1e-5): Adam moves an element whose
    gradient is at noise level by up to lr either way, and a larger lr
    would move the bf16 VGG16 apart by that alone."""
    jcfg, model, params, flat = jax_finetune
    images, enc, dec, lens = _batch(seed=1)
    tx = jtrain.make_finetune_optimizer(jcfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, jcfg, donate=False)
    args = [jnp.asarray(a) for a in (images, enc, dec, lens)]
    want = []
    for _ in range(3):
        state, m = step(state, *args, None, jax.random.PRNGKey(1))
        want.append({k: float(v) for k, v in m.items()})
    cfg = _ft_cfg()
    trainer = ttrain.Trainer(cfg, device="cpu", params=flat,
                             ops=_ops(_eps(cfg)))
    assert trainer.cnn_dropout is None
    arrays = (torch.from_numpy(images), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90))
    got = [{k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
           for _ in range(3)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["annealing"] == w["annealing"] == 1.0     # fine-tune
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(g[key] - w[key]) <= FT_RTOL * abs(w[key]), (i, key, g, w)
    moved = export_flax_params(trainer.model)
    jp = _flat(state.params)
    # the weights moved alike: on average to 5% (as test_torch_train.py
    # compares them); conv1_1's gradient passes the whole bf16 stack, so
    # its moves are held to their direction (cosine 0.94 measured)
    for key in ("vgg16/conv1_1/kernel", "vgg16/fc2/kernel",
                "cvae/decoder/rnn_logits/kernel"):
        delta_t, delta_j = moved[key] - flat[key], jp[key] - flat[key]
        assert np.abs(delta_j).max() > 0, key
        if key == "vgg16/conv1_1/kernel":
            cos = (delta_t * delta_j).sum() / np.sqrt(
                (delta_t ** 2).sum() * (delta_j ** 2).sum())
            assert cos >= 0.9, (key, cos)
        else:
            assert (np.abs(delta_t - delta_j).mean()
                    <= 0.05 * np.abs(delta_j).mean()), key


# -------------------------------------------------------------- optimizer

def _nest(flat):
    """Flat ``"a/b/c"`` keys → the nested tree optax walks."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _small_ft(**kw):
    cfg = Config(embed_size=16, encoder_hidden=16, decoder_hidden=16,
                 latent_size=4, gen_z_samples=2, fine_tune=True,
                 image_size=S, image_net_weights_path="/nonexistent.npz",
                 **kw)
    cfg.vocab_size = 20
    return cfg


@pytest.mark.parametrize("kw", [
    dict(),
    dict(fine_tune_fe=False),
    dict(fine_tune_top=False),
    dict(fine_tune_fe=False, fine_tune_top=False),
    dict(cnn_optimizer="SGD", num_ex_per_epoch=4, batch_size=2),
    dict(cnn_optimizer="Momentum", optimizer="SGD"),
], ids=["default", "frozen-fe", "frozen-top", "frozen-cnn", "cnn-sgd",
        "cnn-momentum"])
def test_finetune_optimizer_matches_optax_multi_transform(kw):
    """Three updates from the same large gradients: the main chain clips
    over its own gradients only (5.0, far below the VGG gradients' norm),
    the CNN chain adds weight decay (1e-2 here, to show) and runs at
    cnn_lr (1e-2), frozen groups keep their weights."""
    kw = dict(weight_decay=1e-2, cnn_lr=1e-2, **kw)
    cfg = _small_ft(**kw)
    model = FineTuneModel.from_config(cfg)
    params = ttrain.init_flax_params(model, 0)
    load_flax_params(model, params)
    opt = ttrain.make_finetune_optimizer(cfg, model)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "optimizer", "cnn_optimizer", "learning_rate", "cnn_lr",
        "weight_decay", "lstm_clip_by_norm", "fine_tune_fe", "fine_tune_top",
        "num_ex_per_epoch", "batch_size", "num_epochs_per_decay")})
    jcfg.fine_tune = True
    tx = jtrain.make_finetune_optimizer(jcfg)
    jparams = _nest(params)
    jstate = tx.init(jparams)
    layout = {name: (key, perm) for key, (name, perm) in
              ttrain.flax_layout(model).items()}
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = {k: rng.normal(0, 3.0, size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        jgrads = _nest(grads)
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        t_grads = [from_flax_array(grads[layout[n][0]], layout[n][1])
                   for n, _ in model.named_parameters()]
        norm = opt.step(t_grads)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(jgrads)),
                                   rtol=1e-5)
    got, want = export_flax_params(model), _flat(jparams)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        frozen = ((key.startswith("vgg16/conv") and not cfg.fine_tune_fe)
                  or (key.startswith("vgg16/fc") and not cfg.fine_tune_top))
        assert np.array_equal(got[key], params[key]) == frozen, key


# ------------------------------------------------------------ train, decode

def _image_arrays(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    lens = torch.full((n * 2,), 5, dtype=torch.int32)
    enc = torch.from_numpy(rng.integers(3, 20, (n * 2, 5)))
    dec = torch.roll(enc, 1, 1)
    dec[:, 0] = 1
    return (torch.from_numpy(_images(n, seed)), enc, dec, lens,
            torch.zeros(n, 90))


@pytest.mark.parametrize("kw,moves", [
    (dict(), ("conv", "fc")),
    (dict(fine_tune_fe=False), ("fc",)),
    (dict(fine_tune_top=False), ("conv",)),
], ids=["default", "frozen-fe", "frozen-top"])
def test_finetune_trainer_moves_the_unfrozen_vgg_weights(kw, moves):
    cfg = _small_ft(mode="training", cnn_lr=1e-3, **kw)
    trainer = ttrain.Trainer(cfg, device="cpu")
    assert isinstance(trainer.model, FineTuneModel)
    assert trainer.cnn_dropout is not None      # cnn_dropout 0.5 keeps half
    before = export_flax_params(trainer.model)
    arrays = _image_arrays(cfg)
    m = [trainer.run_step_arrays(arrays) for _ in range(2)]
    assert all(np.isfinite(float(x["loss"])) for x in m)
    after = export_flax_params(trainer.model)
    for key in before:
        kind = ("conv" if key.startswith("vgg16/conv") else
                "fc" if key.startswith("vgg16/fc") else "cvae")
        moved = not np.array_equal(before[key], after[key])
        if kind == "cvae" and key.endswith("kernel"):
            assert moved, key
        elif kind != "cvae":
            assert moved == (kind in moves), key


def test_finetune_resume_equals_uninterrupted(tmp_path):
    """The train state holds every optimizer group and VGG16's dropout
    generator: 2 + 2 steps equal 4."""
    cfg = _small_ft(mode="training", cnn_lr=1e-3, fine_tune_top=False)
    arrays = _image_arrays(cfg)
    whole = ttrain.Trainer(cfg.replace(), device="cpu")
    want = [whole.run_step_arrays(arrays) for _ in range(4)]
    first = ttrain.Trainer(cfg.replace(), device="cpu")
    for _ in range(2):
        first.run_step_arrays(arrays)
    states = Checkpointer(str(tmp_path), "ft")
    states.save(first.train_state())
    saved = first.train_state()
    assert {"rng/seeds", "rng/cnn_dropout"} <= set(saved.arrays)
    assert set(saved.meta["optimizer"]) == {"main", "cnn_fe"}
    resumed = ttrain.Trainer(cfg.replace(restore=True), device="cpu")
    resumed.restore_from(states)
    got = [resumed.run_step_arrays(arrays) for _ in range(2)]
    for g, w in zip(got, want[2:]):
        assert all(torch.equal(g[k], w[k]) for k in w)
    for a, b in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)


def test_finetune_decodes_from_images():
    """A fine-tune model decodes from images as its CVAE decodes from
    their fc2 features; its checkpoint reloads as a FineTuneModel."""
    cfg = _small_ft(gen_max_len=5, beam_size=2, mode="inference")
    model = FineTuneModel.from_config(cfg)
    load_flax_params(model, ttrain.init_flax_params(model, 0))
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(17)])
    images = torch.from_numpy(_images())
    c_v = torch.zeros(2, 90)
    fns = make_decode_fns(model, cfg, vocab)
    with torch.no_grad():
        feats = model.vgg16(images)
    plain = make_decode_fns(cvae_of(model), cfg.replace(fine_tune=False), vocab)
    eps = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16)).astype(np.float32))
    for mode in ("greedy", "beam_search"):
        got = fns[mode](images, c_v, eps=eps)
        want = plain[mode](feats, c_v, eps=eps)
        assert torch.equal(got.tokens, want.tokens), mode
        assert got.tokens.shape == (2, 5)


# ------------------------------------------------------------------ stores

def test_raw_image_store_round_trip(mini_coco, tmp_path):
    """The port's packer writes what the JAX packer writes; the native
    gather and the numpy fallback return the packed images in request
    order, duplicates included."""
    split_dir = os.path.join(mini_coco, "images", "val2014")
    ours, theirs = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    index = tnative.pack_images_to_raw([split_dir], ours)
    assert index == jnative.pack_images_to_raw([split_dir], theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    names = sorted(index)
    want = np.stack([timages.load_image(os.path.join(split_dir, n))
                     for n in names]).astype(np.uint8)
    request = [names[3], names[0], names[3]]
    for force_numpy in (False, True):
        store = tnative.RawImageStore(ours, force_numpy=force_numpy)
        assert store.loader == ("numpy" if force_numpy else "native")
        assert len(store) == len(names)
        store.prefetch(request)
        got = store.get_batch(request)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want[[3, 0, 3]])
        store.close()
    arrays = _images(3, size=8)
    tnative.write_raw(arrays, ["a.jpg", "b.jpg", "c.jpg"], str(tmp_path / "w.bin"))
    store = tnative.RawImageStore(str(tmp_path / "w.bin"))
    np.testing.assert_array_equal(store.get_batch(["c.jpg", "a.jpg"]),
                                  arrays[[2, 0]])
    with pytest.raises(ValueError):
        tnative.write_raw(arrays, ["a.jpg"], str(tmp_path / "x.bin"))


def test_hdf5_image_store_round_trip(mini_coco, tmp_path):
    split_dir = os.path.join(mini_coco, "images", "train2014")
    ours, theirs = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    index = timages.pack_images_to_hdf5([split_dir], ours)
    assert index == jimages.pack_images_to_hdf5([split_dir], theirs)
    names = sorted(index)
    request = [names[5], names[1], names[5]]
    store, jstore = timages.Hdf5ImageStore(ours), jimages.Hdf5ImageStore(theirs)
    got = store.get_batch(request)
    np.testing.assert_array_equal(got, jstore.get_batch(request))
    np.testing.assert_array_equal(
        got[1], timages.load_image(os.path.join(split_dir, names[1]))
        .astype(np.uint8))
    store.close()
    jstore.close()


def test_data_takes_the_raw_file_then_hdf5_then_jpgs(mini_coco, tmp_path):
    base = dict(coco_dir=mini_coco, cache_dir=str(tmp_path / "c"),
                obj_vectors_dir=str(tmp_path / "o"), fine_tune=True,
                batch_size=2)
    raw, h5 = str(tmp_path / "all.bin"), str(tmp_path / "all.h5")
    dirs = [os.path.join(mini_coco, "images", s) for s in ("train2014",
                                                          "val2014")]
    tnative.pack_images_to_raw(dirs, raw)
    timages.pack_images_to_hdf5(dirs, h5)
    stores = {}
    for name, kw in (("raw", dict(raw_images_file=raw, hdf5_file=h5,
                                  use_hdf5=True)),
                     ("hdf5", dict(raw_images_file="", hdf5_file=h5,
                                   use_hdf5=True)),
                     ("jpg", dict(raw_images_file="", hdf5_file="",
                                  use_hdf5=False))):
        data = tdataset.Data(Config(**base, **kw))
        batcher = data.train_batcher()
        stores[name] = type(batcher.image_store).__name__
        batch = next(batcher.train_batches())
        assert batch.features.shape == (2, 224, 224, 3)
    assert stores == {"raw": "RawImageStore", "hdf5": "Hdf5ImageStore",
                      "jpg": "NoneType"}
