"""Fused LSTM decode step: CUDA kernel wrapper and its plain version.

Counterpart of ``vae_captioning_tpu/ops/fused_lstm_step.py``.  One call
advances N decode lanes by one step:

    gates = [x, bf16(h)] @ W + b      bf16 operands, f32 accumulation
    c'    = sigmoid(f + forget_bias)·c + sigmoid(i)·tanh(g)
    h'    = sigmoid(o)·tanh(c')       gate order i, f, g, o

The caller gathers ``x = embed_bf16[tokens]`` (as the TPU path does
outside its kernel), so the same call also serves the ``init_state``
steps on the image, cluster-vector and z embeddings.

On CUDA tensors the wrapper launches ``csrc/fused_lstm_step.cu``, whose
[N, 4H] gates never reach device memory; on CPU tensors it takes
:func:`fused_lstm_step_plain`, which rounds at the same points.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vae_captioning_torch import _ext

NAME = "fused_lstm_step"


def fused_lstm_step_plain(x: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          forget_bias: float = 1.0,
                          reverse_sum: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's maths in plain PyTorch: bf16-rounded operands upcast
    to f32, an f32 matmul, f32 bias and gate maths.  ``reverse_sum``
    sums each dot product in reverse order, the same maths rounded
    another way."""
    zh = torch.cat([x.to(torch.bfloat16), h.to(torch.bfloat16)], dim=-1).float()
    wf = w.to(torch.bfloat16).float()
    if reverse_sum:
        zh, wf = zh.flip(-1), wf.flip(0)
    gates = zh @ wf + b.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = (torch.sigmoid(f + forget_bias) * c.float()
             + torch.sigmoid(i) * torch.tanh(g))
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def fused_lstm_step(x: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor,
                    forget_bias: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N,E] bf16, c/h [N,H] f32, w [E+H,4H] bf16, b [4H] f32 →
    (c', h') [N,H] f32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.  No backward: raises RuntimeError when
    grad mode is on and an input requires grad."""
    _ext.forbid_grad(NAME, x, c, h, w, b)
    if _ext.on_cpu(x, c, h, w, b):
        return fused_lstm_step_plain(x, c, h, w, b, forget_bias)
    N, E = x.shape
    H = c.shape[1]
    req = _ext.require
    req(x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
        f"{NAME}: x and w must be bfloat16, got {x.dtype}, {w.dtype}")
    req(c.dtype == h.dtype == b.dtype == torch.float32,
        f"{NAME}: c, h and b must be float32")
    req(c.shape == h.shape == (N, H) and w.shape == (E + H, 4 * H)
        and b.shape == (4 * H,),
        f"{NAME}: shapes x{tuple(x.shape)} c{tuple(c.shape)} "
        f"h{tuple(h.shape)} w{tuple(w.shape)} b{tuple(b.shape)} disagree")
    req(E % 32 == 0 and H % 32 == 0,
        f"{NAME}: E={E} and H={H} must be multiples of 32")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in (x, c, h, w, b)),
        f"{NAME}: inputs must be contiguous and 16-byte aligned")
    new_c = torch.empty_like(c)
    new_h = torch.empty_like(h)
    with torch.cuda.device(x.device):
        err = _ext.library().vct_fused_lstm_step(
            x.data_ptr(), c.data_ptr(), h.data_ptr(), w.data_ptr(),
            b.data_ptr(), new_c.data_ptr(), new_h.data_ptr(), N, E, H,
            float(forget_bias), _ext.stream_ptr(x.device))
    _ext.check_launch(err, NAME)
    _ext.LAUNCHES[NAME] += 1
    return new_c, new_h
