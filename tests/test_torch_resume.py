"""Resuming a run (vae_captioning_torch/checkpoint.py ``Checkpointer``,
train.py ``Trainer.train_state`` / ``restore_from``): 3 steps, a saved
train state, a fresh Trainer restored from it and 3 more steps equal 6
uninterrupted steps bit for bit on the CPU (parameters, moments,
metrics), for every prior and optimizer; a JAX ``TrainState`` after 3
steps, converted to the port's format, resumes in both packages under
``restore=True`` to test_torch_train.py's tolerances, with the
annealing forced to 1.0 in both; retention at ``max_to_keep``; and a
file that does not match raises ValueError naming the key while an IO
error propagates as the OSError it is (no retry)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from test_torch_train import (METRIC_RTOL, _batch, _cv, _eps, _ops,  # noqa: F401
                              ag_jax_model, interpreted, jax_model)
from vae_captioning_tpu import train as jtrain
from vae_captioning_torch import checkpoint as ckpt
from vae_captioning_torch import train as ttrain
from vae_captioning_torch.checkpoint import Checkpointer, TrainState
from vae_captioning_torch.config import Config

B, K, T, V = 2, 3, 6, 50
KEYS = ("loss", "rec_loss", "kld", "grad_norm", "annealing")


def _small(**kw):
    cfg = Config(embed_size=64, encoder_hidden=64, decoder_hidden=64,
                 latent_size=8, gen_z_samples=4, **kw)
    cfg.vocab_size = V
    return cfg


def _arrays(seed=0):
    feats, enc, dec, lens = _batch(seed)
    cv = np.random.default_rng(seed).dirichlet(np.ones(90), size=B)
    return (torch.from_numpy(feats), torch.from_numpy(enc).long(),
            torch.from_numpy(dec).long(), torch.from_numpy(lens),
            torch.from_numpy(cv.astype(np.float32)))


def _moments(trainer):
    return [t for _, t, _ in trainer._moments()]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(prior="AG", use_c_v=True),
    dict(prior="GMM", use_c_v=True, fused_ce=True, dec_keep_rate=0.7),
    dict(prior="AG", use_c_v=True, optimizer="Momentum"),
    dict(optimizer="SGD", num_ex_per_epoch=4, batch_size=2),
], ids=["normal", "ag", "gmm-dropout", "momentum", "sgd-decay"])
def test_three_plus_three_steps_equal_six(tmp_path, kw):
    arrays = _arrays()
    whole = ttrain.Trainer(_small(**kw), device="cpu")
    want = [whole.run_step_arrays(arrays) for _ in range(6)]
    first = ttrain.Trainer(_small(**kw), device="cpu")
    for _ in range(3):
        first.run_step_arrays(arrays)
    states = Checkpointer(str(tmp_path), "run")
    states.save(first.train_state())
    assert states.all_steps() == [3]
    resumed = ttrain.Trainer(_small(restore=True, **kw), device="cpu")
    resumed.restore_from(states)
    assert resumed.host_step == 3
    got = [resumed.run_step_arrays(arrays) for _ in range(3)]
    for g, w in zip(got, want[3:]):
        for key in KEYS:
            assert torch.equal(g[key], w[key]), key
    for a, b in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(_moments(resumed), _moments(whole)):
        assert torch.equal(a, b)
    assert resumed.optimizer.count == whole.optimizer.count == 6
    assert resumed.next_seed() == whole.next_seed()


def _adam_state(opt_state):
    """(count, mu, nu) of ``make_optimizer``'s chain: clip, then adam."""
    adam = opt_state[1][0]
    return int(adam.count), adam.mu, adam.nu


def _flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(tree)).items()}


def _from_jax(state, trainer) -> TrainState:
    """A JAX ``TrainState`` in the port's train-state format (its
    generators' states are the fresh Trainer's own)."""
    count, mu, nu = _adam_state(state.opt_state)
    arrays = {f"params/{k}": v for k, v in _flat(state.params).items()}
    arrays.update({f"opt/main/mu/{k}": v for k, v in _flat(mu).items()})
    arrays.update({f"opt/main/nu/{k}": v for k, v in _flat(nu).items()})
    arrays.update({k: v for k, v in trainer.train_state().arrays.items()
                   if k.startswith("rng/")})
    step = int(state.step)
    return TrainState(step, arrays, {"step": step, "optimizer": {
        "main": {"kind": "Adam", "count": count}}})


@pytest.mark.parametrize("prior", ["Normal", "AG"])
def test_resume_matches_the_jax_restore(interpreted, jax_model, ag_jax_model,
                                        tmp_path, prior):
    """3 JAX steps, then 3 more under ``restore=True`` in both packages
    from that state (ann_param 3: annealing 0.0025 at step 3 unless a
    restore forces it to 1.0)."""
    cfg, model, params, flat = jax_model if prior == "Normal" else ag_jax_model
    cfg = cfg.replace(ann_param=3.0)
    feats, enc, dec, lens = _batch(seed=2)
    cv = _cv(2) if prior == "AG" else None
    args = [jnp.asarray(a) for a in (feats, enc, dec, lens)] + [
        None if cv is None else jnp.asarray(cv)]
    tx = jtrain.make_optimizer(cfg)
    state = jtrain.TrainState.create(params, tx)
    step = jtrain.make_train_step(model, tx, cfg, donate=False)
    for _ in range(3):
        state, m = step(state, *args, jax.random.PRNGKey(1))
    assert float(m["annealing"]) < 0.01
    cfg_r = cfg.replace(restore=True)
    trainer = ttrain.Trainer(cfg_r.replace(), device="cpu", params=flat,
                             ops=_ops(_eps(cfg)))
    states = Checkpointer(str(tmp_path), "jax")
    states.save(_from_jax(state, trainer))
    trainer.restore_from(states)
    assert trainer.host_step == 3 and trainer.optimizer.count == 3
    step_r = jtrain.make_train_step(model, tx, cfg_r, donate=False)
    arrays = (torch.from_numpy(feats), torch.from_numpy(enc).long(),
              torch.from_numpy(dec).long(), torch.from_numpy(lens),
              torch.zeros(B, 90) if cv is None else torch.from_numpy(cv))
    for i in range(3):
        state, m = step_r(state, *args, jax.random.PRNGKey(1))
        w = {k: float(v) for k, v in m.items()}
        g = {k: float(v) for k, v in trainer.run_step_arrays(arrays).items()}
        assert w["annealing"] == g["annealing"] == 1.0
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            assert abs(g[key] - w[key]) <= METRIC_RTOL * abs(w[key]), (i, key, g, w)


def test_restore_forces_annealing_without_a_checkpoint():
    """``restore`` forces the annealing to 1 from the first step, as the
    reference does, whether or not there was anything to restore."""
    arrays = _arrays()
    plain = ttrain.Trainer(_small(ann_param=3.0), device="cpu")
    forced = ttrain.Trainer(_small(ann_param=3.0, restore=True), device="cpu")
    assert float(plain.run_step_arrays(arrays)["annealing"]) < 0.01
    assert float(forced.run_step_arrays(arrays)["annealing"]) == 1.0


def test_retention_keeps_the_newest(tmp_path):
    trainer = ttrain.Trainer(_small(), device="cpu")
    state = trainer.train_state()
    keep2 = Checkpointer(str(tmp_path), "two", max_to_keep=2)
    for step in (5, 1, 9, 7):
        keep2.save(state, step=step)
    assert keep2.all_steps() == [7, 9] and keep2.latest_step() == 9
    keep2.save(state, step=9)                   # the same key: replaced
    assert keep2.all_steps() == [7, 9]
    assert sorted(os.listdir(keep2.directory)) == ["7", "9"]
    every = Checkpointer(str(tmp_path), "all", max_to_keep=0)
    for step in range(4):
        every.save(state, step=step)
    assert every.all_steps() == [0, 1, 2, 3]
    assert Checkpointer(str(tmp_path), "none").latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Checkpointer(str(tmp_path), "none").restore()


def test_fit_saves_every_n_steps_and_each_epoch(tmp_path, monkeypatch):
    """``Trainer.fit`` with ``ckpt_every_steps``: a train state keyed by the
    step every N steps and after the epoch, the newest
    ``max_checkpoints_to_keep`` kept, and ``params.npz`` beside them."""
    arrays = _arrays()
    trainer = ttrain.Trainer(_small(ckpt_every_steps=2, num_ex_per_epoch=8,
                                    num_epochs=1,
                                    max_checkpoints_to_keep=2, batch_size=2),
                             device="cpu")
    monkeypatch.setattr(trainer, "run_step",
                        lambda batch: trainer.run_step_arrays(arrays))

    class Batches:
        def train_batches(self, num_captions):
            for _ in range(5):
                yield type("B", (), {"batch_size": 2})()

    trainer.fit(Batches(), checkpoint_dir=str(tmp_path), checkpoint_name="r")
    states = Checkpointer(str(tmp_path), "r")
    assert trainer.host_step == 5
    assert states.all_steps() == [4, 5]
    assert os.path.exists(os.path.join(states.directory, ckpt.PARAMS_FILE))


def _saved(tmp_path, trainer):
    states = Checkpointer(str(tmp_path), "run")
    states.save(trainer.train_state())
    return states, os.path.join(states.directory, "1")


def _rewrite(path, edit):
    with np.load(os.path.join(path, ckpt.STATE_ARRAYS)) as data:
        arrays = {k: data[k] for k in data.files}
    edit(arrays)
    np.savez(os.path.join(path, ckpt.STATE_ARRAYS), **arrays)


@pytest.mark.parametrize("fault,match", [
    ("extra", "unknown array 'params/decoder/extra'"),
    ("missing", "missing array 'opt/main/nu/imf_emb/kernel'"),
    ("shape", "array 'params/imf_emb/bias' has shape"),
    ("rng", "array 'rng/seeds' has shape"),
    ("kind", "optimizer groups"),
    ("format", "format"),
])
def test_a_file_that_does_not_match_raises_value_error(tmp_path, fault, match):
    arrays = _arrays()
    trainer = ttrain.Trainer(_small(), device="cpu")
    trainer.run_step_arrays(arrays)
    states, path = _saved(tmp_path, trainer)
    edits = {
        "extra": lambda a: a.update({"params/decoder/extra": np.zeros(3)}),
        "missing": lambda a: a.pop("opt/main/nu/imf_emb/kernel"),
        "shape": lambda a: a.update({"params/imf_emb/bias": np.zeros(7)}),
        "rng": lambda a: a.update({"rng/seeds": np.zeros(3, np.uint8)}),
    }
    if fault in edits:
        _rewrite(path, edits[fault])
    else:
        meta_path = os.path.join(path, ckpt.STATE_META)
        with open(meta_path) as f:
            meta = json.load(f)
        if fault == "kind":
            meta["optimizer"]["main"]["kind"] = "SGD"
        else:
            meta["format"] = "orbax"
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    fresh = ttrain.Trainer(_small(), device="cpu")
    before = [p.detach().clone() for p in fresh.model.parameters()]
    with pytest.raises(ValueError, match=match):
        fresh.restore_from(states)
    # nothing was changed before the check failed
    assert all(torch.equal(a, b) for a, b in
               zip(before, fresh.model.parameters()))
    assert fresh.host_step == 0


def test_an_io_error_propagates_as_os_error(tmp_path, monkeypatch):
    """No broad except turns an IO error into a layout-mismatch retry: a
    missing file raises FileNotFoundError, and an OSError from the read
    comes out as itself, after one read."""
    trainer = ttrain.Trainer(_small(), device="cpu")
    trainer.run_step_arrays(_arrays())
    states, path = _saved(tmp_path, trainer)
    calls = []

    def failing_load(*args, **kwargs):
        calls.append(args)
        raise OSError("input/output error")

    monkeypatch.setattr(ckpt.np, "load", failing_load)
    with pytest.raises(OSError, match="input/output error"):
        states.restore()
    assert len(calls) == 1
    monkeypatch.undo()
    os.remove(os.path.join(path, ckpt.STATE_ARRAYS))
    with pytest.raises(FileNotFoundError):
        states.restore()
