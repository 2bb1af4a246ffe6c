"""The f32 compute path (``Config.compute_dtype = "float32"``).

The JAX package gates its LSTM sequence, LSTM step, fused z and AG heads
kernels on bf16 (``vae_captioning_tpu/models/cvae.py``: ``use_fused_seq``,
``use_fused_z`` and ``use_fused_heads`` need ``is_bf16``;
``inference.py``: ``fused_step``): under f32 those run as XLA in f32.
Its CE kernels (under a CE schedule flag) and its decode's logits
kernels (top-k, int8 top-k, sampler) take no such gate: they run under
f32 as under bf16, casting h and the head to bf16 inside.  The port
follows that route: the CE and logits kernel wrappers stay, and the four
gated functions are their plain versions with f32 operands (nothing
rounded to bf16), differentiable by autograd:

* :data:`lstm_step_f32`: ``gates = [x, h] @ W + b``, then the gate maths;
* :data:`lstm_seq_f32`: the masked sequence, ``dynamic_rnn`` masking;
* :data:`z_project_f32`: the K_z draws ``μ + σ·eps`` and the ``z_rnn``
  projection, eps from the fused z's Philox stream (or given);
* :data:`ag_heads_f32`: ``q = h @ W^T + b``, the exp and the c_v combine.

:func:`logits_f32` is the f32 logits head.  The products run in true
f32: :func:`exact_matmuls` turns TF32 off on the card for the duration
of a step or a decode and restores the caller's setting after.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator

import torch

from vae_captioning_torch.ops.fused_ag_heads import ag_heads_plain
from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq_plain
from vae_captioning_torch.ops.fused_lstm_step import fused_lstm_step_plain
from vae_captioning_torch.ops.fused_z import fused_z_plain

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

lstm_step_f32 = functools.partial(fused_lstm_step_plain, operands=torch.float32)
lstm_seq_f32 = functools.partial(fused_lstm_seq_plain, operands=torch.float32)
z_project_f32 = functools.partial(fused_z_plain, operands=torch.float32)
ag_heads_f32 = functools.partial(ag_heads_plain, operands=torch.float32)


def torch_dtype(compute_dtype) -> torch.dtype:
    """``Config.compute_dtype`` ("bfloat16" or "float32", or the torch
    dtype) as a torch dtype; ValueError for any other."""
    if isinstance(compute_dtype, torch.dtype):
        if compute_dtype in DTYPES.values():
            return compute_dtype
    elif str(compute_dtype) in DTYPES:
        return DTYPES[str(compute_dtype)]
    raise ValueError(f"compute_dtype {compute_dtype!r}: the port computes in "
                     f"one of {sorted(DTYPES)}")


@contextlib.contextmanager
def exact_matmuls() -> Iterator[None]:
    """f32 products in f32 on the card (TF32 off for cuBLAS and cuDNN),
    the caller's setting restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def logits_f32(h: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The logits head in f32: h [..., H] @ w [H, V] + b [V]."""
    return h.float() @ w.float() + b.float()
