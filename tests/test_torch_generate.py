"""The single-image API of the port (vae_captioning_torch/generate.py)
against the JAX package's ``Generator``, and its example script.

One checkpoint directory holds both sides' files: the sidecars, the JAX
train state (Orbax, written by the JAX ``Checkpointer``) and the port's
``params.npz`` of the same numpy-drawn parameters.  The JAX side runs its
fused decode (``fused_force``) with the Pallas kernels in interpret mode.
Both sides read the same jpgs with their own ``load_image`` and get the
same fc2 features (a fixed function of the pixels stands in for VGG16 on
both sides, whose bf16 convolutions differ by rounding; the port's VGG16
path runs in its own test) and the same z noise (JAX's
``jax.random.normal`` and the port's ``Decoder.gen_z_embedding`` are
handed one numpy eps).  Captions must be equal, as
tests/test_torch_inference.py holds ``make_decode_fns`` to equal tokens.
The fine-tune checkpoint reads 32x32 images on both sides (``load_image``
patched), so its VGG16 stays small."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_inference import interpreted  # noqa: F401
from vae_captioning_tpu import checkpoint as jckpt
from vae_captioning_tpu import generate as jgen
from vae_captioning_tpu import train as jtrain
from vae_captioning_tpu.config import Config as JConfig
from vae_captioning_tpu.data.vocabulary import Vocabulary as JVocabulary
from vae_captioning_torch import checkpoint as tckpt
from vae_captioning_torch import generate as tgen
from vae_captioning_torch.data import images as timages
from vae_captioning_torch.data.features import FeatureExtractor
from vae_captioning_torch.models.decoder import Decoder

V = 64
E = 32                  # embed size: the z step input the eps feeds
WORDS = ["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(V - 4)]  # + <PAD>
DETECTED = {18: 0.9, 3: 0.7, 44: 0.2}    # 44 is below the 0.5 threshold


def _cfg(**kw):
    base = dict(embed_size=E, latent_size=16, encoder_hidden=32,
                decoder_hidden=32, gen_z_samples=4, prior="AG", use_c_v=True,
                gen_max_len=6, beam_size=3, compute_dtype="bfloat16",
                image_net_weights_path="/nonexistent/vgg16_weights.npz")
    base.update(kw)
    cfg = JConfig(**base)
    cfg.vocab_size = V
    cfg.fused_force = True          # JAX: the fused decode kernels
    return cfg


def _write_checkpoint(root: str, name: str, cfg) -> None:
    """The sidecars, a JAX train state of numpy-drawn parameters (the
    init tree's structure), and the port's params.npz of the same."""
    _, params = jtrain.init_model(cfg.replace(fused_force=False),
                                  jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    flat = {"/".join(k): (0.3 * rng.standard_normal(np.shape(v))
                          ).astype(np.float32)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    tx = (jtrain.make_finetune_optimizer(cfg) if cfg.fine_tune
          else jtrain.make_optimizer(cfg))
    ckpt = jckpt.Checkpointer(root, name)
    ckpt.save(jtrain.TrainState.create(tree, tx), step=1)
    ckpt.close()
    jckpt.save_sidecars(cfg, JVocabulary(WORDS), root, name)
    tckpt.save_params(flat, root, name)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("generate_ckpt"))
    _write_checkpoint(root, "ag", _cfg())
    _write_checkpoint(root, "ft", _cfg(fine_tune=True, image_size=32,
                                       prior="Normal", use_c_v=False))
    return root


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("generate_images")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        path = str(d / f"img_{i}.jpg")
        cv2.imwrite(path, rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        paths.append(path)
    dets = [{"file_name": os.path.basename(paths[0]), "category_id": c,
             "score": s} for c, s in DETECTED.items()]
    det_path = str(d / "dets.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    return paths, det_path


def _fc2(pixels: np.ndarray) -> np.ndarray:
    """The stand-in for VGG16's fc2 [1, 4096]: a fixed function of the
    pixels [1, 224, 224, 3]."""
    flat = np.asarray(pixels, np.float32).reshape(-1)
    return np.maximum(flat[:4096] / 128.0 - 1.0, 0.0)[None]


@pytest.fixture()
def same_inputs(monkeypatch, interpreted):  # noqa: F811
    """Both sides: the stand-in features, one eps, and (for the fine-tune
    checkpoint) 32x32 images."""
    eps = np.random.default_rng(11).standard_normal((1, E)).astype(np.float32)
    j_orig = jax.random.normal

    def j_normal(key, shape, dtype=jnp.float32):
        # the decode's z draw; the JAX Generator's init draws others
        if tuple(shape) != eps.shape:
            return j_orig(key, shape, dtype)
        return jnp.asarray(eps, dtype)

    monkeypatch.setattr(jax.random, "normal", j_normal)
    orig = Decoder.gen_z_embedding

    def t_gen_z(self, z_mean, std, n_samples, **_):
        return orig(self, z_mean, std, n_samples,
                    eps=torch.from_numpy(eps).to(z_mean.device))

    monkeypatch.setattr(Decoder, "gen_z_embedding", t_gen_z)
    monkeypatch.setattr(
        jgen.Generator, "_get_features",
        lambda self, img_path: jnp.asarray(_fc2(jgen.load_image(img_path)[None])))
    monkeypatch.setattr(
        tgen.Generator, "_features",
        lambda self, pixels: (torch.from_numpy(np.asarray(pixels, np.float32))
                              if self.cfg.fine_tune
                              else torch.from_numpy(_fc2(pixels))))
    small = lambda path, size=32: timages.load_image(path, 32)  # noqa: E731
    return small


@pytest.mark.parametrize("method,beam,beams", [
    ("greedy", None, False), ("beam_search", 2, False),
    ("beam_search", 2, True), ("beam_search", 3, True)])
@pytest.mark.parametrize("source", ["zeros", "detections", "explicit"])
def test_captions_match_jax(checkpoints, images, same_inputs, method, beam,
                            beams, source):
    paths, det_path = images
    kw = dict(detections_json=det_path) if source == "detections" else {}
    jg = jgen.Generator(checkpoints, "ag", gen_method=method, **kw)
    tg = tgen.Generator(checkpoints, "ag", gen_method=method, device="cpu",
                        **kw)
    vec = None
    if source == "explicit":
        vec = np.random.default_rng(5).random(90).astype(np.float32)
    for path in paths:     # with detections: one image found, one not
        want = jg.generate_caption(path, beam_size=beam, cluster_vector=vec,
                                   return_beams=beams)
        got = tg.generate_caption(path, beam_size=beam, cluster_vector=vec,
                                  return_beams=beams)
        assert got == want
        assert got[0]["image_id"] == os.path.basename(path)
        if beams:
            assert len(got[0]["caption"]) == beam


def test_fine_tune_checkpoint_matches_jax(checkpoints, images, same_inputs,
                                          monkeypatch):
    """Raw pixels into each side's FineTuneModel (its VGG16 in bf16)."""
    monkeypatch.setattr(jgen, "load_image", same_inputs)
    monkeypatch.setattr(tgen, "load_image", same_inputs)
    for method, beam in (("greedy", None), ("beam_search", 2)):
        jg = jgen.Generator(checkpoints, "ft", gen_method=method)
        tg = tgen.Generator(checkpoints, "ft", gen_method=method, device="cpu")
        for path in images[0]:
            assert (tg.generate_caption(path, beam_size=beam)
                    == jg.generate_caption(path, beam_size=beam))


def test_detector_vectors_and_per_beam_cache(checkpoints, images,
                                             monkeypatch):
    """The detections JSON gives the image its indicator (categories
    above 0.5), sliced [1:]; decode fns are built once per beam size."""
    paths, det_path = images
    built = []
    make = tgen.make_decode_fns
    monkeypatch.setattr(tgen, "make_decode_fns",
                        lambda *a, **k: built.append(a[1].beam_size) or make(*a, **k))
    monkeypatch.setattr(tgen.Generator, "_features",
                        lambda self, pixels: torch.from_numpy(_fc2(pixels)))
    gen = tgen.Generator(checkpoints, "ag", gen_method="beam_search",
                         detections_json=det_path, device="cpu")
    vec = gen._det_vectors[os.path.basename(paths[0])]
    assert vec[18] > 0 and vec[3] > 0 and vec[44] == 0
    c_v = gen._cluster_vector(os.path.basename(paths[0]), None)
    np.testing.assert_array_equal(c_v.numpy()[0], vec[1:])
    assert not gen._cluster_vector(os.path.basename(paths[1]), None).any()
    for beam in (2, 3, 2, 3, 2):
        gen.generate_caption(paths[0], beam_size=beam)
    assert built == [3, 2]          # the config's beam at build, then 2


def test_sample_is_seeded(checkpoints, images, monkeypatch):
    monkeypatch.setattr(tgen.Generator, "_features",
                        lambda self, pixels: torch.from_numpy(_fc2(pixels)))
    gen = tgen.Generator(checkpoints, "ag", gen_method="sample", device="cpu")
    path = images[0][0]
    first = gen.generate_caption(path)
    assert gen.generate_caption(path) == first
    assert gen.generate_caption(path, seed=gen.cfg.seed) == first
    assert isinstance(first[0]["caption"], str)


def test_features_come_from_the_extractor_at_batch_one(checkpoints, images,
                                                       vgg_npz):
    """Without the stand-in: fc2 from FeatureExtractor(batch 1) on the
    weights given, and the caption from those features."""
    gen = tgen.Generator(checkpoints, "ag", weights_path=vgg_npz,
                         device="cpu")
    pixels = timages.load_image(images[0][0])[None]
    got = gen._features(pixels)
    assert gen._extractor.batch_size == 1
    want = FeatureExtractor(vgg_npz, batch_size=1, device="cpu")(pixels)
    np.testing.assert_array_equal(got.numpy(), want)
    g = torch.Generator().manual_seed(gen.cfg.seed)
    tokens = gen.decode_fns(gen.cfg.beam_size)["greedy"](
        got, torch.zeros((1, 90)), generator=g).tokens
    caption = tgen.tokens_to_text(tokens[0].numpy(), gen.vocab.idx2word,
                                  gen.vocab.eos_id, gen.vocab.bos_id)
    assert gen.generate_caption(images[0][0]) == [
        {"image_id": os.path.basename(images[0][0]), "caption": caption}]


def test_train_state_only_checkpoint_loads(checkpoints, tmp_path,
                                           monkeypatch):
    """A checkpoint whose parameters are only in a train state (the
    port's Checkpointer) loads them."""
    root = str(tmp_path)
    cfg, vocab = tckpt.load_sidecars(checkpoints, "ag")
    tckpt.save_sidecars(cfg, vocab, root, "states")
    params = tckpt.load_params(checkpoints, "ag")
    tckpt.Checkpointer(root, "states").save(tckpt.TrainState(
        4, {f"params/{k}": v for k, v in params.items()}, {}))
    a = tgen.Generator(checkpoints, "ag", device="cpu")
    b = tgen.Generator(root, "states", device="cpu")
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)


def test_errors(checkpoints, images, tmp_path):
    with pytest.raises(ValueError, match="gen_method"):
        tgen.Generator(checkpoints, "ag", gen_method="nucleus", device="cpu")
    gen = tgen.Generator(checkpoints, "ag", device="cpu")
    with pytest.raises(FileNotFoundError, match="image not found"):
        gen.generate_caption(str(tmp_path / "missing.jpg"))
    with pytest.raises(ValueError, match="return_beams"):
        gen.generate_caption(images[0][0], return_beams=True)
    with pytest.raises(FileNotFoundError):
        tgen.Generator(str(tmp_path), "nothing", device="cpu")


def test_main_prints_the_caption(checkpoints, images, same_inputs, capsys):
    path = images[0][0]
    tgen.main(["--img_path", path, "--checkpoint_dir", checkpoints,
               "--checkpoint", "ag", "--gen_method", "beam_search",
               "--beam_size", "3", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    want = jgen.Generator(checkpoints, "ag", gen_method="beam_search")
    assert printed == want.generate_caption(path, beam_size=3)[0]["caption"]


def test_example_script_runs(checkpoints, images, same_inputs, monkeypatch,
                             capsys):
    import runpy
    import sys

    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples",
        "generate_caption_example_torch.py")
    monkeypatch.setattr(sys, "argv", [
        script, "--img_path", images[0][0], "--checkpoint_dir", checkpoints,
        "--checkpoint", "ag", "--device", "cpu"])
    runpy.run_path(script, run_name="__main__")
    out = capsys.readouterr().out
    assert "greedy" in out and "beam (k=2)" in out
