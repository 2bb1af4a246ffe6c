"""Flax parameters ↔ the port's modules.

The reference keeps its parameters as a Flax tree: nested dicts keyed by
module name (``models/cvae.py``: ``imf_emb``, ``cv_emb``, ``encoder``,
``decoder/{dec_embeddings,lstm/cell_i,z_rnn,rnn_logits}``), with Dense
kernels laid out [in, out].  This module copies such a tree, nested or
flattened to ``"a/b/c"`` keys, of numpy arrays into a port model:

* a Dense ``kernel`` becomes an ``nn.Linear`` ``weight``, transposed;
* an ``embedding`` becomes an ``nn.Embedding`` ``weight`` as it is;
* an LSTM cell keeps its [E+H, 4H] ``kernel`` (x rows first), the layout
  the CUDA kernel reads.

Every parameter the port has must be present with its shape; a key the
port does not know, or a wrong shape, raises ``ValueError``.  The port
has a counterpart for every parameter of every prior's tree, the
encoder's included.  :func:`export_flax_params` is the inverse: a
trained port model back to flat Flax keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

@dataclass
class BridgeReport:
    loaded: List[str] = field(default_factory=list)    # Flax keys copied


def flatten(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested mapping → ``{"a/b/c": leaf}``; flat ``"a/b/c"`` keys pass
    through."""
    out: Dict[str, Any] = {}
    for key, value in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        else:
            out[path] = value
    return out


def flax_layout(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """``{flax key: (torch parameter name, transposed)}`` for every
    parameter of ``model``."""
    layout: Dict[str, Tuple[str, bool]] = {}
    for mod_name, mod in model.named_modules():
        path = mod_name.replace(".cells.", ".cell_").split(".")
        for pname, _ in mod.named_parameters(recurse=False):
            transpose = False
            if isinstance(mod, nn.Linear):
                leaf = "kernel" if pname == "weight" else pname
                transpose = pname == "weight"
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = pname
            layout["/".join(path + [leaf])] = (f"{mod_name}.{pname}", transpose)
    return layout


def flax_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """``{flax key: shape in the Flax layout}`` for every parameter."""
    params = dict(model.named_parameters())
    return {key: tuple(params[name].shape[::-1] if t else params[name].shape)
            for key, (name, t) in flax_layout(model).items()}


def load_flax_params(model: nn.Module, params: Mapping[str, Any]
                     ) -> BridgeReport:
    """Copy Flax parameters (numpy arrays) into ``model`` in place."""
    flat = flatten(params)
    layout = flax_layout(model)
    targets = dict(model.named_parameters())
    report = BridgeReport()
    staged: Dict[str, torch.Tensor] = {}
    for key in sorted(flat):
        if key not in layout:
            raise ValueError(f"unknown Flax parameter {key!r}: the port "
                             "has no counterpart for it")
        name, transpose = layout[key]
        array = np.asarray(flat[key], dtype=np.float32)
        value = torch.tensor(array)
        if transpose:
            value = value.t()
        if tuple(value.shape) != tuple(targets[name].shape):
            want = tuple(targets[name].shape)
            raise ValueError(
                f"Flax parameter {key!r} has shape {array.shape}, the port "
                f"expects {want[::-1] if transpose else want}")
        staged[name] = value
        report.loaded.append(key)
    missing = sorted(set(layout) - set(flat))
    if missing:
        raise ValueError(f"Flax parameters missing for the port: {missing}")
    with torch.no_grad():
        for name, value in staged.items():
            targets[name].copy_(value)
    return report


def export_flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """``{flax key: f32 array in the Flax layout}`` for every parameter of
    ``model``: the inverse of :func:`load_flax_params`."""
    params = dict(model.named_parameters())
    out: Dict[str, np.ndarray] = {}
    for key, (name, transpose) in flax_layout(model).items():
        value = params[name].detach().float().cpu()
        out[key] = (value.t() if transpose else value).contiguous().numpy()
    return out
