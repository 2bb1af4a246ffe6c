"""The benchmark's one point of contact with the program under test,
``vae_captioning_torch``: its configuration, its model with the run's
weights, its decode fns and its Trainer, and its kernel counters.  The
reference and the yardstick import nothing from here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.bridge import flax_layout, flax_shapes
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.vocabulary import Vocabulary

SPECIALS = ["<BOS>", "<EOS>", "<UNK>"]


def config(cfg: dict, seed: int, **traffic) -> Config:
    """The program's Config of a configuration file, the run's seed and
    the traffic's settings (beam, batch)."""
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in cfg.items() if k in fields and k != "seed"}
    kw.update(traffic)
    out = Config(seed=seed, **kw)
    out.vocab_size = cfg["vocab_size"]
    return out


def vocabulary(size: int) -> Vocabulary:
    """PAD 0, <BOS> 1, <EOS> 2, <UNK> 3, then words to ``size`` ids."""
    return Vocabulary(SPECIALS + [f"w{i}" for i in range(size - 4)])


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 shapes: Dict[str, tuple]) -> None:
    """Copy the run's Flax-layout weights into ``model`` on its device,
    after checking that the model has exactly the reference's parameters."""
    have = {k: tuple(v) for k, v in flax_shapes(model).items()}
    if have != {k: tuple(v) for k, v in shapes.items()}:
        raise ValueError(f"the program's parameters {sorted(have.items())} "
                         f"are not the reference's {sorted(shapes.items())}")
    params = dict(model.named_parameters())
    for key, (name, perm) in flax_layout(model).items():
        leaf = weights[key]
        if perm is not None:
            leaf = leaf.permute(tuple(int(i) for i in torch.tensor(perm).argsort()))
        params[name].copy_(leaf)


def flax_leaves(model: torch.nn.Module, tensors) -> Dict[str, torch.Tensor]:
    """Per-parameter tensors (in ``model.parameters()`` order) by Flax key
    and in the Flax layout."""
    by_name = {name: (key, perm) for key, (name, perm) in
               flax_layout(model).items()}
    out = {}
    for (name, _), t in zip(model.named_parameters(), tensors):
        key, perm = by_name[name]
        out[key] = t if perm is None else t.permute(perm)
    return out


def launches() -> Dict[str, int]:
    return dict(_ext.LAUNCHES)


def reset_launches() -> None:
    _ext.reset_launches()


def build() -> float:
    """Load (and at a checkout's first run, build) the kernels; returns
    nvcc's seconds (0.0 when every library was already built)."""
    _ext.library()
    return float(_ext.build_seconds or 0.0)
