"""The port's own config and data modules against the JAX package's:
``Config`` fields and defaults, ``parse_args`` on the same argv, the
``config.json`` and ``vocab.json`` sidecars in both directions, and the
``Data`` facade's vocabulary and batches on the synthetic mini-COCO for
the same seed.  What needs VGG16 or raw images raises, naming A.8.  The
feature and cluster-vector loaders raise ValueError on names that
disagree with their arrays, under ``python -O`` too, and close their npz
files."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from vae_captioning_tpu import config as jconfig
from vae_captioning_tpu.data import dataset as jdataset
from vae_captioning_tpu.data import features as jfeatures
from vae_captioning_tpu.data import vocabulary as jvocab
from vae_captioning_torch import config as tconfig
from vae_captioning_torch.data import batcher as tbatcher
from vae_captioning_torch.data import cluster_vectors as tcluster_vectors
from vae_captioning_torch.data import dataset as tdataset
from vae_captioning_torch.data import features as tfeatures
from vae_captioning_torch.data import vocabulary as tvocab
from vae_captioning_torch.utils.logging import MetricLogger
from vae_captioning_torch.utils.prefetch import Prefetcher


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_are_the_jax_packages():
    assert _fields(tconfig.Config) == _fields(jconfig.Config)
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(
        jconfig.Config())
    assert (tconfig.PRIORS, tconfig.SAMPLE_GENS, tconfig.OPTIMIZERS,
            tconfig.MODES) == (jconfig.PRIORS, jconfig.SAMPLE_GENS,
                               jconfig.OPTIMIZERS, jconfig.MODES)
    assert tconfig._FLAG_TO_FIELD == jconfig._FLAG_TO_FIELD


@pytest.mark.parametrize("argv", [
    [],
    ["--prior", "AG", "--c_v", "--bs", "16", "--lr", "0.001",
     "--set", "gen_batch_size=4096", "--set", "ag_kl_sum=true"],
    ["--coco_dir", "/data/coco", "--epochs", "3", "--mode", "inference",
     "--sample_gen", "greedy", "--dec_drop", "0.75", "--set", "seed=7"],
    ["--no_encoder", "--optimizer", "Momentum", "--embed_dim", "64",
     "--set", "std=0.5", "--set", "prefetch_batches=0"],
])
def test_parse_args_gives_the_same_config(argv):
    got = dataclasses.asdict(tconfig.parse_args(argv))
    assert got == dataclasses.asdict(jconfig.parse_args(argv))


def test_parse_args_reads_a_config_file(tmp_path):
    path = str(tmp_path / "c.json")
    jconfig.Config(prior="AG", batch_size=7, latent_size=12).save(path)
    argv = ["--config", path, "--bs", "9"]
    got = tconfig.parse_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(jconfig.parse_args(argv))
    assert (got.prior, got.batch_size, got.latent_size) == ("AG", 9, 12)


@pytest.mark.parametrize("writer,reader", [
    (jconfig.Config, tconfig.Config), (tconfig.Config, jconfig.Config)])
def test_config_json_moves_both_ways(tmp_path, writer, reader):
    cfg = writer(prior="AG", use_c_v=True, num_clusters=12, ag_kl_sum=True,
                 gen_batch_size=256)
    cfg.vocab_size = 321
    path = str(tmp_path / "sub" / "config.json")
    cfg.save(path)
    loaded = reader.load(path)
    assert type(loaded) is reader
    assert dataclasses.asdict(loaded) == dataclasses.asdict(cfg)
    assert loaded.needs_cluster_vectors


@pytest.mark.parametrize("writer,reader", [
    (jvocab.Vocabulary, tvocab.Vocabulary), (tvocab.Vocabulary, jvocab.Vocabulary)])
def test_vocab_json_moves_both_ways(tmp_path, writer, reader):
    caps = [["<BOS>", "a", "cat", "sits", "<EOS>"],
            ["<BOS>", "a", "dog", "sits", "<EOS>"],
            ["<BOS>", "a", "cat", "runs", "<EOS>"]]
    vocab = writer.build(caps, keep_words=2)
    path = str(tmp_path / "vocab.json")
    vocab.save(path)
    loaded = reader.load(path)
    assert loaded.idx2word == vocab.idx2word
    assert (loaded.bos_id, loaded.eos_id, loaded.unk_id) == (
        vocab.bos_id, vocab.eos_id, vocab.unk_id)
    assert loaded.encode(["a", "cat", "zebra"]) == vocab.encode(["a", "cat", "zebra"])


def _data(module, config_cls, mini_coco, root, **kw):
    cfg = config_cls(coco_dir=mini_coco, cache_dir=str(root / "cache"),
                     obj_vectors_dir=str(root / "obj"), batch_size=4,
                     gen_val_captions=2, hdf5_file="", raw_images_file="",
                     prior="AG", use_c_v=True, **kw)
    rng = np.random.default_rng(0)
    os.makedirs(cfg.cache_dir, exist_ok=True)
    for split in ("train2014", "val2014", "test2014"):
        files = sorted(os.listdir(os.path.join(mini_coco, "images", split)))
        tfeatures.FeatureStore(files, rng.normal(size=(len(files), 4096))).save(
            os.path.join(cfg.cache_dir, f"{split}.features.npz"))
    return module.Data(cfg, extract_features=True)


def _same_batches(got, want):
    n = 0
    for a, b in zip(got, want):
        for name in ("features", "labels", "dec_inputs", "lengths",
                     "cluster_vectors", "image_ids"):
            x, y = getattr(a, name), getattr(b, name)
            if y is None:
                assert x is None, name
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)
        assert (a.valid, a.cv_fallbacks) == (b.valid, b.cv_fallbacks)
        n += 1
    return n


@pytest.mark.parametrize("num_captions", [1, 5])
def test_data_gives_the_same_vocab_and_batches(mini_coco, tmp_path, num_captions):
    t = _data(tdataset, tconfig.Config, mini_coco, tmp_path / "port",
              num_captions=num_captions)
    j = _data(jdataset, jconfig.Config, mini_coco, tmp_path / "jax",
              num_captions=num_captions)
    assert t.vocab.idx2word == j.vocab.idx2word
    assert t.config.vocab_size == j.config.vocab_size
    tb, jb = t.train_batcher(), j.train_batcher()
    for _ in range(2):          # two epochs: the shuffles stay in step
        assert _same_batches(tb.train_batches(num_captions),
                             jb.train_batches(num_captions)) >= 3
    assert _same_batches(t.val_batcher().eval_batches(num_captions),
                         j.val_batcher().eval_batches(num_captions)) == 1
    assert _same_batches(t.test_batcher().image_batches(),
                         j.test_batcher().image_batches()) == 1
    cv = next(tb.train_batches(num_captions)).cluster_vectors
    assert cv.shape == (4, 90) and np.allclose(cv.sum(axis=1), 1.0)
    assert t.val_references() == j.val_references()


def test_what_needs_vgg16_raises(mini_coco, tmp_path):
    """Without a cache the extractor needs VGG16's weights (a missing file
    raises); with one it reads the cache.  A batcher without a store
    loads the jpgs, and a fine-tune ``Data`` serves images."""
    split_dir = os.path.join(mini_coco, "images", "train2014")
    with pytest.raises(FileNotFoundError, match="vgg16.npz"):
        tfeatures.extract_features_from_dir(split_dir, "vgg16.npz",
                                            cache_dir=str(tmp_path),
                                            device="cpu")
    store = jfeatures.FeatureStore(["a.jpg"], np.ones((1, 4096)))
    store.save(str(tmp_path / "train2014.features.npz"))
    got = tfeatures.extract_features_from_dir(split_dir, "vgg16.npz",
                                              cache_dir=str(tmp_path))
    np.testing.assert_array_equal(got.features, store.features)
    first = sorted(os.listdir(split_dir))[0]
    batcher = tbatcher.CaptionBatcher([os.path.join(split_dir, first)],
                                      {first: [[1, 4, 2]]}, 1)
    batch = next(batcher.eval_batches())
    assert batch.features.shape == (1, 224, 224, 3)
    assert batch.features.dtype == np.float32
    cfg = tconfig.Config(coco_dir=mini_coco, cache_dir=str(tmp_path / "c"),
                         obj_vectors_dir=str(tmp_path / "obj"),
                         fine_tune=True, batch_size=2, hdf5_file="",
                         raw_images_file="")
    batch = next(tdataset.Data(cfg).train_batcher().train_batches())
    assert batch.features.shape == (2, 224, 224, 3)


def test_metric_logger_and_prefetcher(tmp_path):
    log = MetricLogger(str(tmp_path), echo=False, run_name="r")
    log.log(3, {"loss": 1.5}, epoch=0)
    log.close()
    with open(tmp_path / "r.metrics.jsonl") as f:
        assert '"loss": 1.5' in f.read()
    assert list(Prefetcher(iter(range(5)), depth=2)) == list(range(5))

    def failing():
        yield 1
        raise KeyError("boom")

    stream = Prefetcher(failing())
    assert next(stream) == 1
    with pytest.raises(KeyError, match="boom"):
        next(stream)


# ----------------------------------------------------------------------
# the loaders check their arrays and close their npz files
# ----------------------------------------------------------------------

def test_feature_store_rejects_names_that_disagree_with_rows():
    with pytest.raises(ValueError, match="3 names for 2 feature rows"):
        tfeatures.FeatureStore(["a.jpg", "b.jpg", "c.jpg"], np.ones((2, 8)))


def test_feature_store_check_holds_under_python_O(tmp_path):
    """The check is no assert: ``python -O`` keeps it."""
    script = ("import numpy as np\n"
              "from vae_captioning_torch.data.features import FeatureStore\n"
              "try:\n"
              "    FeatureStore(['a.jpg', 'b.jpg'], np.ones((3, 4)))\n"
              "except ValueError as e:\n"
              "    print('raised', e)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-O", "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "raised FeatureStore: 2 names for 3 feature rows" in proc.stdout


def test_cluster_vectors_reject_names_that_disagree_with_vectors(tmp_path):
    path = str(tmp_path / "c_v.npz")
    np.savez(path, names=np.array(["a.jpg", "b.jpg"]),
             vectors=np.ones((3, 90), np.float32))
    with pytest.raises(ValueError, match="2 names for 3 cluster vectors"):
        tcluster_vectors.load(path)


@pytest.fixture()
def npz_opened(monkeypatch):
    """np.load wrapped: every NpzFile it returns is kept."""
    opened, orig = [], np.load

    def load(*args, **kwargs):
        out = orig(*args, **kwargs)
        opened.append(out)
        return out

    monkeypatch.setattr(np, "load", load)
    return opened


def test_feature_store_load_closes_its_npz(tmp_path, npz_opened):
    path = str(tmp_path / "f.features.npz")
    tfeatures.FeatureStore(["a.jpg", "b.jpg"], np.arange(8.0).reshape(2, 4)).save(path)
    store = tfeatures.FeatureStore.load(path)
    np.testing.assert_array_equal(store.get_batch(["b.jpg"]), [[4, 5, 6, 7]])
    assert len(npz_opened) == 1 and npz_opened[0].zip is None


def test_cluster_vectors_load_closes_its_npz(tmp_path, npz_opened):
    path = str(tmp_path / "c_v.npz")
    tcluster_vectors.save({"a.jpg": np.ones(90), "b.jpg": np.zeros(90)}, path)
    vectors = tcluster_vectors.load(path)
    assert sorted(vectors) == ["a.jpg", "b.jpg"] and vectors["a.jpg"].sum() == 90
    assert len(npz_opened) == 1 and npz_opened[0].zip is None
