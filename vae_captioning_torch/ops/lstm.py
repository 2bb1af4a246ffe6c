"""LSTM cell and stack, single-step and masked-sequence forms
(counterpart of ``vae_captioning_tpu/ops/lstm.py``).

One fused cell: ``gates = [x, h] @ W + b`` with W [E+H, 4H], the x rows
first, gate order (i, f, g, o) and the TF-LSTMCell ``forget_bias = 1.0``.
W keeps the Flax layout, which is what the CUDA kernels read.

* The single step goes through the ``fused_lstm_step`` wrapper (the
  decode kernel on CUDA, the plain version on the CPU) when no gradient
  is wanted.  When one is (grad mode on and an input or weight requires
  grad) it runs :func:`fused_lstm_step_plain`, which autograd
  differentiates: the train path's conditioning steps (image, cluster
  vector, z), as the JAX package computes them with XLA and not with a
  kernel.  The decode kernel has no backward.
* The masked sequence (``dynamic_rnn`` semantics: steps at t ≥ length
  copy the carry through and emit zeros) goes through ``fused_lstm_seq``
  (forward and backward kernels on CUDA, plain versions on the CPU).

Everything computes in bf16 with f32 accumulation, the reference's
default; other compute types are not ported yet (ROADMAP D.2).  The
decode fns of ``inference.py`` cast the kernel once and step through
``make_lstm_fn`` instead, init steps included.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq
from vae_captioning_torch.ops.fused_lstm_step import (fused_lstm_step,
                                                      fused_lstm_step_plain)

# carry for one layer: (c, h), each [B, H] f32; a stack carries a tuple
LayerCarry = Tuple[torch.Tensor, torch.Tensor]
Carry = Tuple[LayerCarry, ...]
# the masked sequence layer: (x [T,N,E], wx, wh, b, c0, h0, lengths) →
# ((c_T, h_T), hs [T,N,H]); fused_lstm_seq or fused_lstm_seq_plain
SeqFn = Callable[..., Tuple[LayerCarry, torch.Tensor]]


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
        """One step: x [B, E] → ((c', h'), h').  The plain step when a
        gradient is wanted (autograd differentiates it), the decode kernel
        otherwise."""
        c, h = carry
        args = (x.to(torch.bfloat16), c, h, self.kernel.to(torch.bfloat16),
                self.bias)
        wants_grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
        step = fused_lstm_step_plain if wants_grad else fused_lstm_step
        new_c, new_h = step(*args, self.forget_bias)
        return (new_c, new_h), new_h

    def sequence(self, carry: LayerCarry, x: torch.Tensor,
                 lengths: torch.Tensor, seq_fn: SeqFn = fused_lstm_seq
                 ) -> Tuple[LayerCarry, torch.Tensor]:
        """Masked sequence: x [T, B, E] time-major, lengths [B] int32 →
        ((c_T, h_T), hs [T, B, H] bf16, zeros at masked steps)."""
        if self.forget_bias != 1.0:
            raise NotImplementedError("the sequence kernels fix forget_bias "
                                      "at 1.0, the reference's value")
        E = x.shape[-1]
        c, h = carry
        return seq_fn(x, self.kernel[:E], self.kernel[E:], self.bias, c, h,
                      lengths)


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

    def forward(self, carry: Carry, xs: torch.Tensor, lengths: torch.Tensor,
                time_major_out: bool = False, collect_outputs: bool = True,
                seq_fn: SeqFn = fused_lstm_seq
                ) -> Tuple[Carry, Optional[torch.Tensor]]:
        """Masked sequence run (``dynamic_rnn`` semantics): xs [B, T, E],
        lengths [B] → (carry at each row's length, outputs [B, T, H] bf16
        with zeros at t ≥ length).  ``time_major_out`` returns [T, B, H];
        ``collect_outputs=False`` returns None (the encoder reads only
        the carry).  Both apply to the last layer."""
        inp = xs.transpose(0, 1)            # time-major for the kernels
        lengths = lengths.to(torch.int32)
        new_carry = []
        for cell, layer_carry in zip(self.cells, carry):
            layer_carry, inp = cell.sequence(layer_carry, inp, lengths, seq_fn)
            new_carry.append(layer_carry)
        if not collect_outputs:
            return tuple(new_carry), None
        return tuple(new_carry), inp if time_major_out else inp.transpose(0, 1)
