"""Decoding over data-parallel ranks (``inference.make_decode_fns`` with a
``DataParallel``, ``run_inference`` and the quality hook under
``multihost``) against one process and the JAX package's single-device
decode.

Two ranks over gloo on the CPU (processes spawned as in
tests/test_torch_parallel.py) decode a batch of 5 images, which is not a
multiple of the ranks: each rank takes 3 rows of the batch padded to 6,
and the gathered result drops the padding.

* With the same explicit z noise, beam search (every beam, its scores)
  and greedy decoding on every rank equal one process token for token
  and score for score (the decode kernels' plain versions are row-wise:
  bit for bit), and the JAX decode fns (their Pallas kernels in
  interpret mode, ``jax.random.normal`` patched to that noise) token for
  token, beam scores to rtol 1e-5 as tests/test_torch_inference.py holds
  them.
* With the noise drawn from the generator, every rank draws it for the
  global batch: beam and greedy again equal one process.
* The sampler (fused, and the unfused multinomial) folds the rank into
  its seed: rows that are equal on the two ranks draw different tokens.
* On ranks the LSTM step and the top-k are handed the launch plans of
  the batch's real rows (5, or 5 · beam), not of the padded shares.
* ``run_inference``: rank 0 alone writes the JSON files, equal to one
  process's; rank 1 writes nothing.  The quality hook returns rank 0's
  numbers on every rank, equal to one process's."""

import json
import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vae_captioning_torch import inference as tinf
from vae_captioning_torch.bridge import load_flax_params
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.batcher import CaptionBatcher
from vae_captioning_torch.data.features import FeatureStore
from vae_captioning_torch.data.vocabulary import Vocabulary
from vae_captioning_torch.models.cvae import CVAEModel
from vae_captioning_torch.parallel import mesh
from vae_captioning_torch.parallel.kernel_shard import DataParallel

WORLD = 2
B = 5                    # images a decode batch: not a multiple of WORLD
VOCAB = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + [f"w{i}" for i in range(60)])


def _cfg(**kw):
    base = dict(embed_size=32, latent_size=16, encoder_hidden=32,
                decoder_hidden=32, gen_z_samples=4, prior="AG", use_c_v=True,
                gen_max_len=6, beam_size=3, compute_dtype="bfloat16",
                gen_batch_size=B, temperature=1.0)
    base.update(kw)
    cfg = Config(**base)
    cfg.vocab_size = 64
    return cfg


def _inputs(seed=0, n=B):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, 4096)).astype(np.float32)
    c_v = (rng.random((n, 90)) * (rng.random((n, 90)) < 0.1)).astype(np.float32)
    eps = rng.normal(size=(n, 32)).astype(np.float32)
    return feats, c_v, eps


def _batchers(seed=4, n_val=7, n_test=5):
    rng = np.random.default_rng(seed)
    out = []
    for split, n in (("val", n_val), ("test", n_test)):
        names = [f"COCO_{split}_{i:04d}.jpg" for i in range(n)]
        store = FeatureStore(names, rng.normal(size=(n, 4096)))
        c_v = {nm: (rng.random(91) * (rng.random(91) < 0.1)).astype(np.float32)
               for nm in names}
        caps = {nm: [[VOCAB.bos_id, 5 + i % 3, 9, VOCAB.eos_id]]
                for i, nm in enumerate(names)}
        out.append((names, store, c_v, caps))
    (vn, vs, vc, vcap), (tn, ts, tc, _) = out
    val = CaptionBatcher(vn, vcap, B, feature_store=vs, cluster_vectors=vc,
                         filename_to_imid={n: 100 + i for i, n in enumerate(vn)})
    test = CaptionBatcher(tn, {}, B, feature_store=ts, cluster_vectors=tc,
                          filename_to_imid={n: 200 + i for i, n in enumerate(tn)})
    refs = {str(100 + i): ["w2 w6", "w3 w6 w1"] for i in range(n_val)}
    return val, test, refs


def _model(flat, **kw):
    model = CVAEModel.from_config(_cfg(**kw))
    load_flax_params(model, flat)
    return model.eval()


PLANS = []     # (op, plan_rows) of each recorded decode-op call


def _recording(fn, op):
    """``fn`` recording the ``plan_rows`` it is called with."""
    def wrapped(*args, plan_rows=None, **kwargs):
        PLANS.append((op, plan_rows))
        return fn(*args, plan_rows=plan_rows, **kwargs)
    return wrapped


def _plans(model, cfg, dp, feats, c_v, eps):
    """The plan_rows that beam search and greedy hand the LSTM step and
    the top-k, by op."""
    ops = tinf.PLAIN_OPS._replace(
        lstm_step=_recording(tinf.PLAIN_OPS.lstm_step, "lstm"),
        logits_top_k=_recording(tinf.PLAIN_OPS.logits_top_k, "topk"))
    fns = tinf.make_decode_fns(model, cfg, VOCAB, ops=ops, dp=dp)
    out = {}
    for name in ("beam_search", "greedy"):
        PLANS.clear()
        fns[name](feats, c_v, eps=eps)
        out[name] = sorted(set(PLANS), key=str)
    return out


def _decode_all(flat, dp, out_dir):
    """Every decode of the test, through ``dp``'s ranks (or one process)."""
    cfg = _cfg(multihost=dp.world > 1)
    model = _model(flat)
    fns = tinf.make_decode_fns(model, cfg, VOCAB, dp=dp)
    feats, c_v, eps = (torch.from_numpy(a) for a in _inputs())
    res = {}
    for name in ("beam_search_all", "greedy"):
        given = fns[name](feats, c_v, eps=eps)
        drawn = fns[name](feats, c_v,
                          generator=torch.Generator().manual_seed(7))
        res[name] = (given.tokens.numpy(), None if given.scores is None
                     else given.scores.numpy(), drawn.tokens.numpy())
    res["plans"] = _plans(model, cfg, dp, feats, c_v, eps)
    # rows 0-2 (rank 0's share of 6) equal rows 3-5 (rank 1's)
    same = [torch.cat([t[:3], t[:3]]) for t in (feats, c_v, eps)]
    for fused in (True, False):
        sample = tinf.make_decode_fns(model, cfg.replace(fused_decode=fused),
                                      VOCAB, dp=dp)["sample"]
        res[f"sample fused={fused}"] = sample(
            same[0], same[1], generator=torch.Generator().manual_seed(3),
            eps=same[2]).tokens.numpy()
    val, test, refs = _batchers()
    os.makedirs(out_dir, exist_ok=True)
    paths = tinf.run_inference(cfg.replace(std=0.0), model, VOCAB, val, test,
                               output_dir=out_dir)
    res["files"] = sorted(os.listdir(out_dir))
    res["json"] = {}
    for split, path in paths.items():
        if os.path.exists(path):
            with open(path) as f:
                res["json"][split] = json.load(f)
    hook = tinf.make_quality_hook(cfg, VOCAB, refs)
    val, _, _ = _batchers()
    res["quality"] = hook(model, val, torch.Generator().manual_seed(5))
    return res


def _worker(rank: int, world: int, port: int, flat: dict, out: str) -> None:
    torch.set_num_threads(1)
    mesh.init_process_group(rank, world, f"tcp://127.0.0.1:{port}", "cpu",
                            backend="gloo", timeout=120)
    try:
        res = _decode_all(flat, DataParallel.current(),
                          os.path.join(out, f"json{rank}"))
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def params():
    import jax
    from flax.traverse_util import flatten_dict

    from vae_captioning_tpu.config import Config as JConfig
    from vae_captioning_tpu.train import init_model

    cfg = JConfig(**{k: v for k, v in vars(_cfg()).items()})
    cfg.vocab_size = 64
    _, params = init_model(cfg, jax.random.PRNGKey(0))
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    return cfg, params, flat


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    """(each rank's results, one process's)."""
    _, _, flat = params
    out = str(tmp_path_factory.mktemp("decode_dp"))
    mp.start_processes(_worker, args=(WORLD, _free_port(), flat, out),
                       nprocs=WORLD, join=True, start_method="spawn")
    ranks = []
    for rank in range(WORLD):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    one = _decode_all(flat, DataParallel(), os.path.join(out, "one"))
    return ranks, one


def test_shard_rows_pads_and_gather_trims():
    x = torch.arange(10).reshape(5, 2)
    shares = [DataParallel(r, WORLD).shard_rows(x) for r in range(WORLD)]
    assert [s.shape[0] for s in shares] == [3, 3]
    assert torch.equal(torch.cat(shares)[:5], x)
    assert not shares[1][-1].any()                   # the padding row
    assert DataParallel().shard_rows(x) is x
    assert DataParallel().gather_rows(x, 5) is x


@pytest.mark.parametrize("name", ["beam_search_all", "greedy"])
def test_ranks_decode_as_one_process(runs, name):
    ranks, one = runs
    for res in ranks:
        for got, want in zip(res[name], one[name]):
            if want is None:
                assert got is None
            else:
                assert got.shape[0] == B
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["beam_search_all", "greedy"])
def test_ranks_decode_as_the_jax_package(runs, params, name, monkeypatch):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from vae_captioning_tpu import inference as jinf
    from vae_captioning_tpu.models.cvae import CVAEModel as JaxCVAE

    cfg, jparams, _ = params
    cfg = cfg.replace(fused_force=True)
    feats, c_v, eps = _inputs()
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    want = jinf.make_decode_fns(JaxCVAE.from_config(cfg), cfg, VOCAB)[name](
        jparams, jnp.asarray(feats), jnp.asarray(c_v), jax.random.PRNGKey(0))
    ranks, _ = runs
    tokens, scores, _ = ranks[0][name]
    if name == "beam_search_all":
        want_tokens, want_scores = want
        np.testing.assert_allclose(scores, np.asarray(want_scores), rtol=1e-5)
    else:
        want_tokens = want
    np.testing.assert_array_equal(tokens, np.asarray(want_tokens))


@pytest.mark.parametrize("fused", [True, False])
def test_sampler_ranks_draw_distinct_streams(runs, fused):
    ranks, one = runs
    tokens = ranks[0][f"sample fused={fused}"]
    np.testing.assert_array_equal(tokens, ranks[1][f"sample fused={fused}"])
    # each rank decoded rows 0-2 of the same inputs: a shared stream would
    # give rows 3-5 rows 0-2's tokens
    assert not np.array_equal(tokens[:3], tokens[3:])
    # one process draws its rows from one stream, so they differ as well
    assert not np.array_equal(one[f"sample fused={fused}"][:3],
                              one[f"sample fused={fused}"][3:])


def test_rank_zero_alone_writes_the_files_as_one_process(runs):
    ranks, one = runs
    assert ranks[0]["files"] == one["files"] and len(one["files"]) == 2
    assert ranks[1]["files"] == []
    assert ranks[0]["json"] == one["json"]
    assert len(one["json"]["val"]) == 7 and len(one["json"]["test"]) == 5


def test_a_share_of_rows_plans_as_the_batchs_real_rows(runs):
    """On ranks the step kernels take the plans of the batch's real row
    count (B = 5, or 5 · beam), not of the ranks' padded shares (2 · 3
    rows); the conditioning steps, on the whole batch, and one process
    pass no plan."""
    ranks, one = runs
    for res in ranks:
        assert set(res["plans"]["greedy"]) == {("lstm", None), ("lstm", B),
                                               ("topk", B)}
        beam = res["plans"]["beam_search"]
        assert {p for op, p in beam if op == "topk"} == {B * 3}
        assert {p for _, p in beam} <= {None, B, B * 3}
    assert {p for plans in one["plans"].values() for _, p in plans} == {None}


def test_quality_hook_numbers_equal_on_every_rank(runs):
    ranks, one = runs
    assert ranks[0]["quality"] == ranks[1]["quality"] == one["quality"]
    assert set(one["quality"]) == {"val_CIDEr-D", "val_BLEU-4", "val_ROUGE-L",
                                   "val_METEOR_es"}
