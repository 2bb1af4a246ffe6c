"""Checkpoints of the port: the reference's JSON sidecars, a numpy
parameter file and a resumable train state (counterpart of
``vae_captioning_tpu/checkpoint.py``).

A checkpoint ``<directory>/<name>/`` holds

* ``config.json`` and ``vocab.json``, the same sidecars the reference
  writes beside its Orbax checkpoints (``Config.load`` /
  ``Vocabulary.load`` read them);
* ``params.npz``: the model parameters as numpy arrays keyed by their
  Flax path (``"decoder/lstm/cell_0/kernel"``), which go through the
  bridge into the port's modules; inference and :func:`load_model` read
  it;
* ``<step>/state.npz`` + ``<step>/state.json``: the train state at a
  step, in the port's own format (an Orbax file cannot be read without
  JAX), written by :class:`Checkpointer`, which keeps the newest
  ``max_to_keep`` steps.  ``Trainer.train_state`` says what it holds: the
  parameters, the optimizer's moments and counts, the step and the
  generators' states.

A reference checkpoint becomes a port checkpoint by restoring its
parameter tree with the JAX package and passing it to
:func:`save_params`; the sidecars are already in its directory.
Mismatches raise ``ValueError`` naming the key; an IO error propagates
as the ``OSError`` it is.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vae_captioning_torch.bridge import BridgeReport, flatten, load_flax_params
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.vocabulary import Vocabulary
from vae_captioning_torch.models.cvae import CVAEModel
from vae_captioning_torch.models.finetune import FineTuneModel

PARAMS_FILE = "params.npz"
STATE_ARRAYS = "state.npz"
STATE_META = "state.json"
STATE_FORMAT = "vae_captioning_torch.train_state/1"


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
               ) -> Tuple[CVAEModel | FineTuneModel, Vocabulary, BridgeReport]:
    """Build the model of ``cfg`` (default: the checkpoint's own
    config.json; a ``FineTuneModel`` under ``fine_tune``) and load the
    checkpoint's parameters into it, on ``device``: the card unless the
    caller asks for the CPU."""
    saved_cfg, vocab = load_sidecars(directory, name)
    cfg = saved_cfg if cfg is None else cfg
    if cfg.vocab_size not in (None, vocab.vocab_size):
        raise ValueError(f"config vocab_size {cfg.vocab_size} does not match "
                         f"the checkpoint's {vocab.vocab_size} words")
    cfg.vocab_size = vocab.vocab_size
    model = (FineTuneModel if cfg.fine_tune else CVAEModel).from_config(cfg)
    report = load_flax_params(model, load_params(directory, name))
    return model.to(device).eval(), vocab, report


class TrainState(NamedTuple):
    """A train state as numpy arrays keyed by name (``params/<flax key>``,
    ``opt/<group>/{mu,nu}/<flax key>``, ``rng/<generator>``) and a JSON
    record (the step, each optimizer group's kind and count)."""

    step: int
    arrays: Dict[str, np.ndarray]
    meta: Dict[str, Any]


def check_arrays(arrays: Mapping[str, np.ndarray],
                 shapes: Mapping[str, Tuple[int, ...]], where: str) -> None:
    """ValueError naming the first key of ``arrays`` that ``shapes`` does
    not list, the first one it lacks, or the first of another shape."""
    unknown = sorted(set(arrays) - set(shapes))
    if unknown:
        raise ValueError(f"{where}: unknown array {unknown[0]!r}")
    for key in sorted(shapes):
        if key not in arrays:
            raise ValueError(f"{where}: missing array {key!r}")
        if tuple(arrays[key].shape) != tuple(shapes[key]):
            raise ValueError(f"{where}: array {key!r} has shape "
                             f"{tuple(arrays[key].shape)}, expected "
                             f"{tuple(shapes[key])}")


class Checkpointer:
    """Train states under ``<directory>/<name>/<step>/``, keeping the
    newest ``max_to_keep`` (all of them when it is 0 or None)."""

    def __init__(self, directory: str, name: str = "last_run",
                 max_to_keep: Optional[int] = 5):
        self.directory = os.path.abspath(os.path.join(directory, name))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        return sorted(int(e) for e in os.listdir(self.directory)
                      if e.isdigit() and os.path.exists(
                          os.path.join(self.directory, e, STATE_META)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None) -> str:
        """Write ``state`` keyed by ``step`` (default: its own step),
        replacing a checkpoint of that key, then drop the oldest beyond
        ``max_to_keep``; returns its directory.  The files are written
        into a temporary directory that is renamed into place, so a
        reader never sees half a checkpoint."""
        step = state.step if step is None else int(step)
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, STATE_ARRAYS), **state.arrays)
        with open(os.path.join(tmp, STATE_META), "w") as f:
            json.dump({**state.meta, "format": STATE_FORMAT,
                       "step": state.step}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))
        return final

    def restore(self, step: Optional[int] = None) -> TrainState:
        """The train state of ``step`` (default: the newest).
        FileNotFoundError when there is none; ValueError when its files
        are not a train state of this format."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        base = self._step_dir(step)
        with open(os.path.join(base, STATE_META)) as f:
            meta = json.load(f)
        if meta.get("format") != STATE_FORMAT:
            raise ValueError(f"{base}/{STATE_META}: format "
                             f"{meta.get('format')!r}, expected {STATE_FORMAT!r}")
        if not isinstance(meta.get("step"), int):
            raise ValueError(f"{base}/{STATE_META}: no integer 'step'")
        with np.load(os.path.join(base, STATE_ARRAYS)) as data:
            arrays = {k: data[k] for k in data.files}
        return TrainState(meta["step"], arrays, meta)
