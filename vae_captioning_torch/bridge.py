"""Flax parameters ↔ the port's modules.

The reference keeps its parameters as a Flax tree: nested dicts keyed by
module name (``models/cvae.py``: ``imf_emb``, ``cv_emb``, ``encoder``,
``decoder/{dec_embeddings,lstm/cell_i,z_rnn,rnn_logits}``; the fine-tune
model's ``{"vgg16": {conv1_1 .. conv5_3, fc1, fc2}, "cvae": ...}``), with
Dense kernels laid out [in, out] and Conv kernels HWIO.  This module
copies such a tree, nested or flattened to ``"a/b/c"`` keys, of numpy
arrays into a port model:

* a Dense ``kernel`` becomes an ``nn.Linear`` ``weight``, transposed;
* a Conv ``kernel`` [kh, kw, in, out] becomes an ``nn.Conv2d`` ``weight``
  [out, in, kh, kw];
* an ``embedding`` becomes an ``nn.Embedding`` ``weight`` as it is;
* an LSTM cell keeps its [E+H, 4H] ``kernel`` (x rows first), the layout
  the CUDA kernel reads; a stack's cells ``cell_0``, ``cell_1``, ... are
  its ``cells`` in order;
* ``ops/layers.py``'s ``HighwayNetwork`` names its Dense layers ``h_<i>``
  and ``t_<i>`` as the Flax module does, so its tree maps like any other.

Every parameter the port has must be present with its shape; a key the
port does not know, or a wrong shape, raises ``ValueError``.  The port
has a counterpart for every parameter of every prior's tree, the
encoder's included.  :func:`export_flax_params` is the inverse: a
trained port model back to flat Flax keys.  :func:`to_flax_array` /
:func:`from_flax_array` carry any per-parameter tensor (the optimizer's
moments) the same way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

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


# torch layout -> Flax layout, as a permutation of the torch axes
LINEAR_PERM = (1, 0)           # [out, in] -> [in, out]
CONV_PERM = (2, 3, 1, 0)       # [out, in, kh, kw] -> [kh, kw, in, out]
Perm = Optional[Tuple[int, ...]]


def _inverse(perm: Perm) -> Perm:
    return None if perm is None else tuple(int(i) for i in np.argsort(perm))


def to_flax_array(value: torch.Tensor, perm: Perm) -> np.ndarray:
    """A torch-layout tensor as an f32 numpy array in the Flax layout: a
    copy, never a view of the live tensor."""
    value = value.detach().float().cpu()
    if perm is not None:
        value = value.permute(perm)
    return np.array(value.numpy(), order="C")


def from_flax_array(array: Any, perm: Perm) -> torch.Tensor:
    """A Flax-layout array as an f32 tensor in the torch layout."""
    value = torch.tensor(np.asarray(array, dtype=np.float32))
    return value if perm is None else value.permute(_inverse(perm)).contiguous()


def flax_layout(model: nn.Module) -> Dict[str, Tuple[str, Perm]]:
    """``{flax key: (torch parameter name, permutation)}`` for every
    parameter of ``model``; the permutation takes the torch tensor's axes
    to the Flax layout (None: the same layout)."""
    layout: Dict[str, Tuple[str, Perm]] = {}
    for mod_name, mod in model.named_modules():
        path = mod_name.replace(".cells.", ".cell_").split(".")
        for pname, _ in mod.named_parameters(recurse=False):
            perm: Perm = None
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                leaf = "kernel" if pname == "weight" else pname
                if pname == "weight":
                    perm = LINEAR_PERM if isinstance(mod, nn.Linear) else CONV_PERM
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = pname
            layout["/".join(path + [leaf])] = (f"{mod_name}.{pname}", perm)
    return layout


def flax_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """``{flax key: shape in the Flax layout}`` for every parameter."""
    params = dict(model.named_parameters())
    out = {}
    for key, (name, perm) in flax_layout(model).items():
        shape = tuple(params[name].shape)
        out[key] = shape if perm is None else tuple(shape[i] for i in perm)
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]
                     ) -> BridgeReport:
    """Copy Flax parameters (numpy arrays) into ``model`` in place."""
    flat = flatten(params)
    layout = flax_layout(model)
    targets = dict(model.named_parameters())
    staged: Dict[str, torch.Tensor] = {}
    for key in sorted(flat):
        if key not in layout:
            raise ValueError(f"unknown Flax parameter {key!r}: the port "
                             "has no counterpart for it")
        name, perm = layout[key]
        value = from_flax_array(flat[key], perm)
        if tuple(value.shape) != tuple(targets[name].shape):
            raise ValueError(f"Flax parameter {key!r} has shape "
                             f"{np.shape(flat[key])}, the port expects "
                             f"{flax_shapes(model)[key]}")
        staged[name] = value
    missing = sorted(set(layout) - set(flat))
    if missing:
        raise ValueError(f"Flax parameters missing for the port: {missing}")
    with torch.no_grad():
        for name, value in staged.items():
            targets[name].copy_(value)
    return BridgeReport(loaded=sorted(flat))


def export_flax_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """``{flax key: f32 array in the Flax layout}`` for every parameter of
    ``model``: the inverse of :func:`load_flax_params`."""
    params = dict(model.named_parameters())
    return {key: to_flax_array(params[name], perm)
            for key, (name, perm) in flax_layout(model).items()}
