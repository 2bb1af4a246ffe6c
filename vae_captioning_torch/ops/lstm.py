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
  (forward and backward kernels on CUDA, plain versions on the CPU), one
  layer after another.

The stack computes in ``compute_dtype``: bf16 with f32 accumulation, the
reference's default, or f32, where every step is
:data:`~vae_captioning_torch.ops.f32.lstm_step_f32` (the JAX package gates
its LSTM kernels on bf16) and the sequence takes the caller's ``seq_fn``
(``ops/f32.py``'s ``lstm_seq_f32`` on the f32 train path).  The decode
fns of ``inference.py`` cast the kernels once and step through
``make_lstm_fn`` instead, init steps included.

``output_keep_rate`` < 1 is the decoder's LSTM output dropout
(``Config.dec_lstm_drop``, the reference's DropoutWrapper), as the JAX
``LSTMStack._maybe_drop`` applies it: each layer's output, never its
carry, is kept with that probability and scaled by 1 / keep, before the
next layer and before the head.  The sequence form masks each layer's
whole output sequence after that layer's kernel (masked steps stay 0),
which is the JAX ``nn.scan`` path's per-step draw on the same outputs;
only a call given a ``dropout`` source drops (eval and decode never do).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from vae_captioning_torch.ops.f32 import lstm_step_f32
from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq
from vae_captioning_torch.ops.fused_lstm_step import (fused_lstm_step,
                                                      fused_lstm_step_plain)

# carry for one layer: (c, h), each [B, H] f32; a stack carries a tuple
LayerCarry = Tuple[torch.Tensor, torch.Tensor]
Carry = Tuple[LayerCarry, ...]
# the masked sequence layer: (x [T,N,E], wx, wh, b, c0, h0, lengths) →
# ((c_T, h_T), hs [T,N,H]); fused_lstm_seq or fused_lstm_seq_plain
SeqFn = Callable[..., Tuple[LayerCarry, torch.Tensor]]
# where dropout masks come from: a generator (uniforms on its device), or
# a callable shape → bool mask (tests hand in fixed masks)
Dropout = Union[torch.Generator, Callable[[Tuple[int, ...]], torch.Tensor],
                None]


def keep_mask(source: Dropout, shape: Tuple[int, ...], keep: float,
              device: torch.device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, each entry True with
    probability ``keep``: uniforms from the generator ``source`` below
    keep, or the callable's mask for that shape."""
    if isinstance(source, torch.Generator):
        mask = torch.rand(shape, generator=source, device=source.device) < keep
    else:
        mask = source(tuple(shape))
    return mask.to(device)


def drop(x: torch.Tensor, source: Dropout, keep: float) -> torch.Tensor:
    """Inverted dropout of ``x`` in f32: x / keep where the mask keeps, 0
    elsewhere; ``x`` itself when keep ≥ 1 or no source is given."""
    if keep >= 1.0 or source is None:
        return x
    mask = keep_mask(source, tuple(x.shape), keep, x.device)
    return torch.where(mask, x.float() / keep, 0.0)


class LSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 1.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(
            torch.empty(input_size + hidden_size, 4 * hidden_size))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, carry: LayerCarry, x: torch.Tensor
                ) -> Tuple[LayerCarry, torch.Tensor]:
        """One step: x [B, E] → ((c', h'), h').  The plain step when a
        gradient is wanted (autograd differentiates it), the decode kernel
        otherwise; under f32 the f32 step."""
        c, h = carry
        if self.compute_dtype == torch.float32:
            new_c, new_h = lstm_step_f32(x, c, h, self.kernel, self.bias,
                                         self.forget_bias)
            return (new_c, new_h), new_h
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
        ((c_T, h_T), hs [T, B, H], zeros at masked steps) through
        ``seq_fn`` (bf16 outputs from the kernel and its plain version)."""
        if self.forget_bias != 1.0:
            raise NotImplementedError("the sequence kernels fix forget_bias "
                                      "at 1.0, the reference's value")
        E = x.shape[-1]
        c, h = carry
        return seq_fn(x, self.kernel[:E], self.kernel[E:], self.bias, c, h,
                      lengths)


class LSTMStack(nn.Module):
    """Multi-layer LSTM, single-step and masked-sequence application
    (``cell_0``, ``cell_1``, ... as in the Flax tree), with the output
    dropout of ``output_keep_rate``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 output_keep_rate: float = 1.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.output_keep_rate = output_keep_rate
        self.cells = nn.ModuleList(
            LSTMCell(input_size if i == 0 else hidden_size, hidden_size,
                     compute_dtype=compute_dtype)
            for i in range(num_layers))

    def zero_carry(self, batch_size: int,
                   device: torch.device | str = "cpu") -> Carry:
        z = torch.zeros((batch_size, self.hidden_size), dtype=torch.float32,
                        device=device)
        return tuple((z, z) for _ in range(self.num_layers))

    def step(self, carry: Carry, x: torch.Tensor, dropout: Dropout = None
             ) -> Tuple[Carry, torch.Tensor]:
        """One timestep through all layers; input [B, E] → output [B, H].
        With ``dropout``, each layer's output is dropped (the JAX
        ``step`` + ``_maybe_drop``)."""
        new_carry = []
        inp = x
        for cell, layer_carry in zip(self.cells, carry):
            layer_carry, inp = cell(layer_carry, inp)
            inp = drop(inp, dropout, self.output_keep_rate)
            new_carry.append(layer_carry)
        return tuple(new_carry), inp

    def forward(self, carry: Carry, xs: torch.Tensor, lengths: torch.Tensor,
                time_major_out: bool = False, collect_outputs: bool = True,
                seq_fn: SeqFn = fused_lstm_seq, dropout: Dropout = None
                ) -> Tuple[Carry, Optional[torch.Tensor]]:
        """Masked sequence run (``dynamic_rnn`` semantics): xs [B, T, E],
        lengths [B] → (carry at each row's length, outputs [B, T, H] with
        zeros at t ≥ length; bf16, or f32 where dropped or computed in
        f32).  ``time_major_out`` returns [T, B, H];
        ``collect_outputs=False`` returns None (the encoder reads only the
        carry).  Both apply to the last layer.  With ``dropout``, each
        layer's output sequence is dropped after its kernel."""
        inp = xs.transpose(0, 1)            # time-major for the kernels
        lengths = lengths.to(torch.int32)
        new_carry = []
        for cell, layer_carry in zip(self.cells, carry):
            layer_carry, inp = cell.sequence(layer_carry, inp, lengths, seq_fn)
            inp = drop(inp, dropout, self.output_keep_rate)
            new_carry.append(layer_carry)
        if not collect_outputs:
            return tuple(new_carry), None
        return tuple(new_carry), inp if time_major_out else inp.transpose(0, 1)
