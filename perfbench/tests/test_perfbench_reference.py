"""The plain reference against the program's CPU path (the kernels' plain
versions, bf16 operands) at tiny sizes, on the same weights and inputs."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import TINY_WIDTHS
from perfbench import program, traffic, weights
from perfbench.reference import cvae as ref


def tiny_config(name: str) -> dict:
    from perfbench import spec
    bench = spec.benchmark()
    cfg = spec.config(bench, {"config": name})
    cfg.update(TINY_WIDTHS, seed=7)
    return cfg


@pytest.mark.parametrize("name,beam", [("ag512", 10), ("gmm512-flashce", 3)])
def test_decode_matches_the_program(name, beam):
    from vae_captioning_torch.inference import make_decode_fns
    from vae_captioning_torch.models.cvae import CVAEModel
    cfg = tiny_config(name)
    dev = torch.device("cpu")
    shapes = ref.flax_shapes(cfg)
    p = weights.draw(shapes, 7, dev)
    pcfg = program.config(cfg, 7, beam_size=beam, sample_gen="beam_search")
    model = CVAEModel.from_config(pcfg).eval()
    program.load_weights(model, p, shapes)
    fn = make_decode_fns(model, pcfg, program.vocabulary(cfg["vocab_size"]))["beam_search"]
    B = 12
    cv = torch.from_numpy(traffic.cluster_vectors(B, [1, 6], 0.1, 7)[:, 1:])
    feats = torch.from_numpy(traffic.features(B, cfg["cnn_feature_size"], 7, dev))
    eps = traffic.decode_eps(7, 0, B, cfg["embed_size"], dev)
    got = fn(feats, cv, eps=eps)
    with ref.no_tf32():
        carry = ref.decode_init(p, cfg, feats, cv, eps)
        tokens, scores = ref.beam_search(p, cfg, carry, beam, 1, 2)
        rescored, _ = ref.rescore(p, cfg, carry, got.tokens, 1, 2)
    # bf16 operands against f32: the scores of the same captions agree to
    # bf16's rounding over six steps; the captions agree where no near-tie
    assert torch.allclose(got.scores, rescored, atol=5e-3)
    assert (got.tokens == tokens).all(dim=1).float().mean() >= 0.75
    assert torch.allclose(scores, rescored, atol=5e-2) or \
        (scores >= rescored - 5e-3).all()


@pytest.mark.parametrize("name", ["ag512", "gmm512-flashce"])
def test_train_steps_match_the_program(name, tiny):
    from perfbench import drive_train
    from vae_captioning_torch.data.batcher import CaptionBatcher
    from vae_captioning_torch.data.features import FeatureStore
    from vae_captioning_torch.train import Trainer
    import numpy as np
    cfg = tiny_config(name)
    dev = torch.device("cpu")
    shapes = ref.flax_shapes(cfg)
    pcfg = program.config(cfg, 7, batch_size=4, num_captions=5)
    trainer = Trainer(pcfg, device=dev,
                      params={k: np.zeros(s, np.float32) for k, s in shapes.items()})
    p0 = weights.draw(shapes, 7, dev)
    program.load_weights(trainer.model, p0, shapes)
    tr = json.loads((tiny / "traffic" / "train-b256.json").read_text())
    data = traffic.corpus(tr, cfg, 7, dev, "train2014")
    batcher = CaptionBatcher(data.names, data.captions, 4,
                             feature_store=FeatureStore(data.names, data.features),
                             cluster_vectors=data.cluster_vectors, seed=7)
    batches = list(batcher.train_batches(5))[:2]
    losses = [float(trainer.run_step(b)["loss"]) for b in batches]
    want = drive_train.reference_steps(
        p0, cfg, [drive_train.reference_batch(b, dev) for b in batches], 7,
        dev, ref.exact)
    # bf16 operands against f32; the AG KL's 1 / (2 sigma_c^2) = 50 scales
    # the heads' rounding, so its loss agrees to a few 1e-3
    assert losses == pytest.approx(want.losses, rel=5e-3)
    got = program.flax_leaves(trainer.model,
                              [p.detach() for p in trainer.model.parameters()])
    for k in shapes:
        moved, moved_ref = got[k] - p0[k], want.params[k] - p0[k]
        if moved_ref.norm() > 0:
            assert moved.norm() == pytest.approx(float(moved_ref.norm()), rel=0.05), k
