"""LSTM cell and stack, single-step form (counterpart of
``vae_captioning_tpu/ops/lstm.py``).

One fused cell: ``gates = [x, h] @ W + b`` with W [E+H, 4H], the x rows
first, gate order (i, f, g, o) and the TF-LSTMCell ``forget_bias = 1.0``.
W keeps the Flax layout, which is what the CUDA kernel reads.  Decoding
only needs the single step; the masked teacher-forcing sequence form
waits for the train-step slice.

The step goes through the ``fused_lstm_step`` wrapper: the kernel on
CUDA, the plain version on the CPU.  Both compute in bf16 with f32
accumulation, the reference's default; other compute types are not
ported yet (ROADMAP D.2).  The cell casts its kernel on every call; the
decode fns of ``inference.py`` cast it once and step through
``make_lstm_fn`` instead, init steps included.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vae_captioning_torch.ops.fused_lstm_step import fused_lstm_step

# carry for one layer: (c, h), each [B, H] f32; a stack carries a tuple
LayerCarry = Tuple[torch.Tensor, torch.Tensor]
Carry = Tuple[LayerCarry, ...]


class LSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 1.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias
        self.kernel = nn.Parameter(
            torch.empty(input_size + hidden_size, 4 * hidden_size))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, carry: LayerCarry, x: torch.Tensor
                ) -> Tuple[LayerCarry, torch.Tensor]:
        """One step: x [B, E] → ((c', h'), h')."""
        c, h = carry
        new_c, new_h = fused_lstm_step(
            x.to(torch.bfloat16), c, h, self.kernel.to(torch.bfloat16),
            self.bias, self.forget_bias)
        return (new_c, new_h), new_h


class LSTMStack(nn.Module):
    """Multi-layer LSTM, single-step application (``cell_0``, ``cell_1``,
    ... as in the Flax tree)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.cells = nn.ModuleList(
            LSTMCell(input_size if i == 0 else hidden_size, hidden_size)
            for i in range(num_layers))

    def zero_carry(self, batch_size: int,
                   device: torch.device | str = "cpu") -> Carry:
        z = torch.zeros((batch_size, self.hidden_size), dtype=torch.float32,
                        device=device)
        return tuple((z, z) for _ in range(self.num_layers))

    def step(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        """One timestep through all layers; input [B, E] → output [B, H]."""
        new_carry = []
        inp = x
        for cell, layer_carry in zip(self.cells, carry):
            layer_carry, inp = cell(layer_carry, inp)
            new_carry.append(layer_carry)
        return tuple(new_carry), inp
