"""Small layer helpers (counterpart of ``vae_captioning_tpu/ops/layers.py``).

``HighwayNetwork`` is the reference's ``highway_network``
(``utils/rnn_model.py:53-74``, present there but never called, as in the
JAX package): per layer

    y = g · relu(W_h x + b_h) + (1 − g) · x,   g = sigmoid(W_t x + b_t)

with the transform gate's bias initialised to −1.0, which leans the
network toward carrying x early in training.  The Dense layers are
``nn.Linear``s named ``h_<i>`` and ``t_<i>`` as the Flax module names
them, so ``bridge.load_flax_params`` maps its tree one to one.  Plain
PyTorch in f32; no model of the package calls it.
"""

from __future__ import annotations

import torch
from torch import nn


class HighwayNetwork(nn.Module):
    def __init__(self, features: int, num_layers: int = 1,
                 transform_bias_init: float = -1.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            h, t = nn.Linear(features, features), nn.Linear(features, features)
            # kernels of std 1/sqrt(fan_in), as init_flax_params draws
            # them; zero biases, the transform gate's at transform_bias_init
            for dense in (h, t):
                nn.init.normal_(dense.weight, std=features ** -0.5)
                nn.init.zeros_(dense.bias)
            nn.init.constant_(t.bias, transform_bias_init)
            setattr(self, f"h_{i}", h)
            setattr(self, f"t_{i}", t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"h_{i}")(x))
            gate = torch.sigmoid(getattr(self, f"t_{i}")(x))
            x = gate * h + (1.0 - gate) * x
        return x
