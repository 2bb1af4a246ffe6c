"""Zero padding up to the widths the CUDA kernels are built for
(counterpart of the JAX kernels' ``_pad_all`` / ``_pad_inputs`` /
``fused_ag_heads``'s H padding).

Each kernel takes its contraction and hidden widths in steps: the LSTM
step E and H in multiples of 32, the LSTM sequence in multiples of 64,
the fused z E in 64, the AG heads H in 64, the CE one of 64, 128, 256 or
512, the logits top-k and sampler H in 32 and the int8 top-k in 64.  At
any other width the wrappers pad their operands with zeros, launch the
kernel at the padded width and slice its results back.  Zero padding is
exact, not approximate:

* an added contraction term is ``0 · x``;
* a padded LSTM unit has zero weights and bias and starts at c = h = 0,
  so ``c' = σ(1)·0 + σ(0)·tanh(0) = 0`` and ``h' = σ(0)·tanh(0) = 0``:
  it stays 0 and feeds nothing into the real units;
* a padded z column (an output of the projection) is sliced away, and
  its zero cotangent adds nothing to dμ, dσ or the real rows of dW;
* a zero column leaves int8's per-row absmax scale as it is.

Every function here is plain, differentiable PyTorch: autograd of a
padding is the slice of the gradient, so a padded kernel call returns
the gradients of the unpadded inputs, and the CPU tests run the padding
with the plain versions.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def round_up(n: int, multiple: int) -> int:
    """The least multiple of ``multiple`` that is at least ``n``."""
    return -(-n // multiple) * multiple


def next_width(n: int, widths: Sequence[int]) -> int:
    """The least of ``widths`` that is at least ``n``; ValueError past the
    largest."""
    for w in sorted(widths):
        if w >= n:
            return w
    raise ValueError(f"width {n} exceeds the largest kernel width "
                     f"{max(widths)}")


def pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``n`` (itself if already)."""
    extra = n - x.shape[-1]
    return x if extra == 0 else F.pad(x, (0, extra))


def pad_first(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its first dim zero-padded to ``n``."""
    extra = n - x.shape[0]
    if extra == 0:
        return x
    return torch.cat([x, x.new_zeros((extra, *x.shape[1:]))])


def pad_gates(x: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """[..., 4H] gate columns (i, f, g, o blocks of H) → [..., 4Hp], each
    block zero-padded to Hp."""
    if H == Hp:
        return x
    lead = x.shape[:-1]
    return pad_last(x.reshape(*lead, 4, H), Hp).reshape(*lead, 4 * Hp)


def pad_lstm_kernel(w: torch.Tensor, E: int, H: int, Ep: int, Hp: int
                    ) -> torch.Tensor:
    """The fused LSTM kernel [E+H, 4H] (x rows first) → [Ep+Hp, 4Hp]: the
    x rows padded to Ep, the h rows to Hp, every gate block to Hp."""
    if (E, H) == (Ep, Hp):
        return w
    return pad_gates(torch.cat([pad_first(w[:E], Ep), pad_first(w[E:], Hp)]),
                     H, Hp)
