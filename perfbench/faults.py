"""Faults planted under the timed path, to show that the output check
catches them (``perfbench/tests``, and the chip readings that set the
train cells' upper limits).  Each is a context manager that patches the
program for the duration of a run:

* ``decode_token_altered``: one token of each best caption altered where
  the beam search returns it;
* ``decode_half_batch``: the second half of each batch's images left out
  (their captions empty, their scores 0);
* ``decode_stale_state``: every LSTM step returns the carry it was given;
* ``train_stale_state``: the optimizer step leaves the state unchanged;
* ``train_stale_in_window``: the same from the fourth step on, the first
  that the window takes (set-up's three steps are sound);
* ``train_half_batch``: the second half of each batch's images left out,
  the loss's means taken over the rest.
"""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def decode_token_altered():
    from vae_captioning_torch import inference
    search = inference.beam_search

    def altered(*args, **kwargs):
        res = search(*args, **kwargs)
        tokens = res.tokens.clone()
        tokens[:, 0, 0] = 4 + (tokens[:, 0, 0] + 1) % 50    # never the same
        return res._replace(tokens=tokens)

    with mock.patch.object(inference, "beam_search", altered):
        yield


@contextlib.contextmanager
def decode_half_batch():
    from vae_captioning_torch import inference
    search = inference.beam_search

    def half(*args, **kwargs):
        res = search(*args, **kwargs)
        B = res.tokens.shape[0]
        tokens, scores = res.tokens.clone(), res.scores.clone()
        tokens[B // 2:] = 0
        scores[B // 2:] = 0.0
        return res._replace(tokens=tokens, scores=scores)

    with mock.patch.object(inference, "beam_search", half):
        yield


@contextlib.contextmanager
def decode_stale_state():
    from vae_captioning_torch import inference
    make = inference.make_lstm_fn

    def stale_make(*args, **kwargs):
        fn = make(*args, **kwargs)

        def stale(carry, x):
            fn(carry, x)
            return carry, carry[-1][1]
        return stale

    with mock.patch.object(inference, "make_lstm_fn", stale_make):
        yield


@contextlib.contextmanager
def train_stale_state():
    from vae_captioning_torch import train

    def step(self, grads):
        self.count += 1
        return train.global_norm(grads)

    with mock.patch.object(train.Optimizer, "step", step):
        yield


@contextlib.contextmanager
def train_stale_in_window():
    from vae_captioning_torch import train
    sound = train.Optimizer.step

    def step(self, grads):
        if self.count < 3:
            return sound(self, grads)
        self.count += 1
        return train.global_norm(grads)

    with mock.patch.object(train.Optimizer, "step", step):
        yield


@contextlib.contextmanager
def train_half_batch():
    from vae_captioning_torch import train
    device_batch = train.Trainer.device_batch

    def half(self, batch):
        features, labels, dec, lengths, c_v = device_batch(self, batch)
        rows = labels.shape[0] // 2
        labels, dec, lengths = labels.clone(), dec.clone(), lengths.clone()
        labels[rows:] = 0
        dec[rows:] = 0
        lengths[rows:] = 0
        return features, labels, dec, lengths, c_v

    with mock.patch.object(train.Trainer, "device_batch", half):
        yield


FAULTS = {
    "decode": {"token_altered": decode_token_altered,
               "half_batch": decode_half_batch,
               "stale_state": decode_stale_state},
    "train": {"stale_state": train_stale_state,
              "stale_in_window": train_stale_in_window,
              "half_batch": train_half_batch},
}
