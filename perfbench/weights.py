"""The weights of a run, drawn on the device from the seed.

One ``torch.randn`` on a generator on the device fills every kernel and
embedding of the configuration's Flax-layout parameters (biases are
zero), in sorted key order, then each leaf is scaled as its kind is
initialised: Dense kernels by 1/sqrt(fan_in), LSTM kernels by
sqrt(2 / (fan_in + fan_out)), embeddings by 1/sqrt(E).  The program's
model and the reference get the same tensors, drawn again for the
reference once the window has closed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

SALT = 0x5EED


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed ^ SALT)
    keys = sorted(shapes)
    drawn = [k for k in keys if not k.endswith("/bias")]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in drawn),
                       generator=gen, device=device)
    out, offset = {}, 0
    for key in keys:
        shape = shapes[key]
        if key.endswith("/bias"):
            out[key] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        leaf = flat[offset:offset + n].view(shape)
        offset += n
        if key.endswith("/embedding"):
            scale = 1.0 / math.sqrt(shape[1])
        elif "/lstm/" in key:
            scale = math.sqrt(2.0 / (shape[0] + shape[1]))
        else:
            scale = 1.0 / math.sqrt(shape[0])
        out[key] = leaf.mul_(scale)
    return out
