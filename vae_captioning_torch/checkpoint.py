"""Checkpoints of the port: the reference's JSON sidecars plus a numpy
parameter file (counterpart of ``vae_captioning_tpu/checkpoint.py``).

A checkpoint ``<directory>/<name>/`` holds

* ``config.json`` and ``vocab.json``, the same sidecars the reference
  writes beside its Orbax checkpoints (``Config.load`` /
  ``Vocabulary.load`` read them);
* ``params.npz``: the model parameters as numpy arrays keyed by their
  Flax path (``"decoder/lstm/cell_0/kernel"``), which go through the
  bridge into the port's modules.

A reference checkpoint becomes a port checkpoint by restoring its
parameter tree with the JAX package and passing it to
:func:`save_params`; the sidecars are already in its directory.
Mismatches raise ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from vae_captioning_torch.bridge import BridgeReport, flatten, load_flax_params
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.vocabulary import Vocabulary
from vae_captioning_torch.models.cvae import CVAEModel

PARAMS_FILE = "params.npz"


def save_sidecars(cfg: Config, vocab: Vocabulary, directory: str,
                  name: str = "last_run") -> None:
    base = os.path.join(directory, name)
    os.makedirs(base, exist_ok=True)
    cfg.save(os.path.join(base, "config.json"))
    vocab.save(os.path.join(base, "vocab.json"))


def load_sidecars(directory: str, name: str = "last_run"
                  ) -> Tuple[Config, Vocabulary]:
    base = os.path.join(directory, name)
    cfg = Config.load(os.path.join(base, "config.json"))
    vocab = Vocabulary.load(os.path.join(base, "vocab.json"))
    if cfg.vocab_size is not None and cfg.vocab_size != vocab.vocab_size:
        raise ValueError(f"{base}: config.json has vocab_size "
                         f"{cfg.vocab_size} but vocab.json holds "
                         f"{vocab.vocab_size} words")
    return cfg, vocab


def save_params(params: Mapping[str, Any], directory: str,
                name: str = "last_run") -> str:
    """Write a Flax parameter tree (nested, or flat ``"a/b/c"`` keys; any
    array-like leaves) as ``params.npz``; returns its path."""
    base = os.path.join(directory, name)
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, PARAMS_FILE)
    np.savez(path, **{k: np.asarray(v, dtype=np.float32)
                      for k, v in flatten(params).items()})
    return path


def load_params(directory: str, name: str = "last_run") -> Dict[str, np.ndarray]:
    path = os.path.join(directory, name, PARAMS_FILE)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_model(directory: str, name: str = "last_run",
               device: torch.device | str = "cuda",
               cfg: Config | None = None
               ) -> Tuple[CVAEModel, Vocabulary, BridgeReport]:
    """Build the model of ``cfg`` (default: the checkpoint's own
    config.json) and load the checkpoint's parameters into it, on
    ``device``: the card unless the caller asks for the CPU."""
    saved_cfg, vocab = load_sidecars(directory, name)
    cfg = saved_cfg if cfg is None else cfg
    if cfg.vocab_size not in (None, vocab.vocab_size):
        raise ValueError(f"config vocab_size {cfg.vocab_size} does not match "
                         f"the checkpoint's {vocab.vocab_size} words")
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    report = load_flax_params(model, load_params(directory, name))
    return model.to(device).eval(), vocab, report
