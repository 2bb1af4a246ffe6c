"""The port's scorers (vae_captioning_torch/eval/) against the JAX
package's, and its per-epoch caption-quality hook
(inference.make_quality_hook) against the JAX hook: the copies give the
same numbers, bit for bit, on the cases of tests/test_eval.py and
tests/test_meteor.py and on a random corpus; the hook returns what the
JAX hook returns on the same captions; ``Trainer.fit`` and ``cli --set
eval_metrics=True`` report the four scores every epoch."""

import json
import os
import random

import numpy as np
import pytest
import torch

import test_eval as jax_eval_cases
import test_meteor as jax_meteor_cases
from vae_captioning_tpu import inference as jinf
from vae_captioning_tpu.config import Config as JConfig
from vae_captioning_tpu.data.vocabulary import Vocabulary as JVocabulary
from vae_captioning_tpu.eval import meteor as jmeteor
from vae_captioning_tpu.eval import scorers as jscorers
from vae_captioning_torch import cli as tcli
from vae_captioning_torch import inference as tinf
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.batcher import CaptionBatcher
from vae_captioning_torch.data.features import FeatureStore
from vae_captioning_torch.data.vocabulary import Vocabulary
from vae_captioning_torch.eval import meteor as tmeteor
from vae_captioning_torch.eval import scorers as tscorers
from vae_captioning_torch.models.cvae import CVAEModel

REFS = jax_eval_cases.REFS
WORDS = ("a the dog dogs cat cats running runs on grass man men riding "
         "rides horse street holding red plays playing two bus").split()


def _corpus(seed, n=12):
    rng = random.Random(seed)
    refs = {str(i): [" ".join(rng.choice(WORDS) for _ in range(rng.randint(2, 11)))
                     for _ in range(rng.randint(1, 5))] for i in range(n)}
    hyps = {k: " ".join(rng.choice(WORDS) for _ in range(rng.randint(1, 10)))
            for k in refs}
    return hyps, refs


CORPORA = [({k: v[0] for k, v in REFS.items()}, REFS),
           ({k: v[1] for k, v in REFS.items()}, REFS),
           ({"1": "a horse", "2": "a red ball", "3": "the station"}, REFS),
           ({"1": "zzz qqq", "2": "xxx", "3": "yyy www vvv"}, REFS),
           _corpus(0), _corpus(1), _corpus(2, n=40)]


@pytest.mark.parametrize("fn", ["corpus_bleu", "rouge_l", "cider_d"])
@pytest.mark.parametrize("corpus", range(len(CORPORA)))
def test_scorers_equal_the_originals(fn, corpus):
    hyps, refs = CORPORA[corpus]
    assert getattr(tscorers, fn)(hyps, refs) == getattr(jscorers, fn)(hyps, refs)


def test_ptb_tokenize_and_stemmer_equal_the_originals():
    captions = ["A man rides a horse.", "Two dogs, playing -- outside!",
                "it's a \"bus\" (parked) at 5:30pm; ok?", "   ", "Hello... World"]
    for c in captions:
        assert tscorers.ptb_tokenize(c) == jscorers.ptb_tokenize(c)
    for w in jax_meteor_cases.WORDS + WORDS:
        assert tmeteor.porter_stem(w) == jmeteor.porter_stem(w), w


def test_meteor_es_equals_the_original():
    for hyp, refs in jax_meteor_cases.CASES:
        assert tmeteor.meteor_es(hyp, refs) == jmeteor.meteor_es(hyp, refs)
    rng = random.Random(1)
    hyps = [[rng.choice(WORDS) for _ in range(rng.randint(1, 12))]
            for _ in range(100)]
    refs = [[[rng.choice(WORDS) for _ in range(rng.randint(1, 14))]
             for _ in range(rng.randint(1, 3))] for _ in range(100)]
    assert (tmeteor.corpus_meteor_es(hyps, refs)
            == jmeteor.corpus_meteor_es(hyps, refs))
    with pytest.raises(ValueError):
        tmeteor.corpus_meteor_es(hyps, refs[:1])


def test_score_captions_json_and_main_equal_the_originals(tmp_path, capsys):
    results = [{"image_id": 10, "caption": "A man rides a horse."},
               {"image_id": 11, "caption": "Two dogs play."},
               {"image_id": 12, "caption": "no references for me"}]
    gt = {"images": [{"id": 10, "file_name": "a.jpg"},
                     {"id": 11, "file_name": "b.jpg"}],
          "annotations": [
              {"id": 1, "image_id": 10, "caption": "a man rides a horse"},
              {"id": 2, "image_id": 10, "caption": "a person on a horse"},
              {"id": 3, "image_id": 11, "caption": "two dogs play outside"},
              {"id": 4, "image_id": 11, "caption": "dogs playing"}]}
    rp, gp = tmp_path / "results.json", tmp_path / "gt.json"
    rp.write_text(json.dumps(results))
    gp.write_text(json.dumps(gt))
    got = tscorers.score_captions_json(str(rp), str(gp))
    assert got == jscorers.score_captions_json(str(rp), str(gp))
    assert got["scored_images"] == 2 and got["unscored_images"] == 1
    argv = ["--results", str(rp), "--annotations", str(gp)]
    tscorers.main(argv)
    ours = capsys.readouterr().out
    jscorers.main(argv)
    assert ours == capsys.readouterr().out
    assert json.loads(ours) == got


WORDS_VOCAB = ["<BOS>", "<EOS>", "<UNK>"] + WORDS


@pytest.mark.parametrize("case", ["match", "none"])
def test_quality_hook_equals_the_jax_hook(monkeypatch, case):
    """Both hooks score the captions their greedy decode returns; with the
    decode replaced by the same captions, their results are equal (the
    four keys, rounded to 4 places; all zeros when no caption has
    references)."""
    hyps, refs = _corpus(5, n=9)
    caps = [{"image_id": int(k), "caption": v} for k, v in hyps.items()]
    caps += [{"image_id": 77, "caption": "a dog"},     # no references
             {"image_id": 3, "caption": ""}]           # empty caption
    if case == "none":
        refs = {"1000": ["a dog"]}
    monkeypatch.setattr(jinf, "generate_captions", lambda *a, **k: caps)
    monkeypatch.setattr(tinf, "generate_captions", lambda *a, **k: caps)
    jcfg = JConfig(embed_size=8, decoder_hidden=8, encoder_hidden=8,
                   latent_size=4, gen_z_samples=2)
    jcfg.vocab_size = len(WORDS_VOCAB)
    cfg = Config(embed_size=8, decoder_hidden=8, encoder_hidden=8,
                 latent_size=4, gen_z_samples=2)
    cfg.vocab_size = len(WORDS_VOCAB)
    want = jinf.make_quality_hook(jcfg, JVocabulary(WORDS_VOCAB), refs)(
        None, None, None)
    model = CVAEModel.from_config(cfg)
    got = tinf.make_quality_hook(cfg, Vocabulary(WORDS_VOCAB), refs)(
        model, None, torch.Generator().manual_seed(0))
    assert got == want
    assert set(got) == {"val_CIDEr-D", "val_BLEU-4", "val_ROUGE-L",
                        "val_METEOR_es"}
    assert (got["val_CIDEr-D"] == 0.0) == (case == "none")


def test_quality_hook_decodes_through_the_decode_path():
    """The hook for real, on a small AG model on the CPU: a greedy decode
    of every holdout image, the same scores for the same generator."""
    cfg = Config(embed_size=16, decoder_hidden=32, encoder_hidden=32,
                 latent_size=8, gen_z_samples=2, prior="AG", use_c_v=True,
                 gen_max_len=6)
    vocab = Vocabulary(WORDS_VOCAB)
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    names = [f"im{i}.jpg" for i in range(5)]
    rng = np.random.default_rng(0)
    batcher = CaptionBatcher(
        names, {n: [[vocab.bos_id, 4, vocab.eos_id]] for n in names}, 2,
        feature_store=FeatureStore(names, rng.normal(size=(5, 4096))),
        cluster_vectors={n: rng.random(91) for n in names},
        filename_to_imid={n: i for i, n in enumerate(names)})
    refs = {str(i): ["a dog runs", "the cat"] for i in range(5)}
    hook = tinf.make_quality_hook(cfg, vocab, refs)
    first = hook(model, batcher, torch.Generator().manual_seed(3))
    assert first == hook(model, batcher, torch.Generator().manual_seed(3))
    assert all(0.0 <= v for v in first.values())


def test_cli_eval_metrics_prints_the_scores_every_epoch(mini_coco, tmp_path,
                                                        monkeypatch, capsys):
    """``--set eval_metrics=True``: each epoch's line of the four scores,
    and the JSONL metric log holds them."""
    rng = np.random.default_rng(0)
    cache = tmp_path / "cache"
    for split in ("train2014", "val2014"):
        files = sorted(os.listdir(os.path.join(mini_coco, "images", split)))
        FeatureStore(files, rng.normal(size=(len(files), 4096))).save(
            str(cache / f"{split}.features.npz"))
    monkeypatch.chdir(tmp_path)
    tcli.main(["--mode", "training", "--coco_dir", mini_coco, "--device", "cpu",
               "--epochs", "2", "--bs", "4", "--checkpoint", "q",
               "--set", f"cache_dir={cache}",
               "--set", f"checkpoint_dir={tmp_path / 'ckpt'}",
               "--set", f"obj_vectors_dir={tmp_path / 'obj'}",
               "--set", f"log_dir={tmp_path / 'logs'}", "--set", "logging=True",
               "--set", "embed_size=32", "--set", "encoder_hidden=32",
               "--set", "decoder_hidden=32", "--set", "latent_size=8",
               "--set", "gen_z_samples=2", "--set", "num_ex_per_epoch=8",
               "--set", "gen_val_captions=2", "--set", "gen_max_len=5",
               "--set", "eval_metrics=True"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("Validation metrics: ")]
    assert len(lines) == 2
    for key in ("val_CIDEr-D", "val_BLEU-4", "val_ROUGE-L", "val_METEOR_es"):
        assert all(f"{key}: " in line for line in lines)
    records = [json.loads(line) for path in (tmp_path / "logs").glob("*.jsonl")
               for line in path.read_text().splitlines()]
    assert sum("val_CIDEr-D" in r for r in records) == 2
