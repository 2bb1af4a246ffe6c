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
:func:`fused_lstm_step_plain`, which rounds at the same points.  The
kernel takes E and H in multiples of 32: at other widths the wrapper
zero-pads the operands (:func:`pad_lstm_step`, exact: padded units stay
0) and slices c' and h' back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.ops.padding import (pad_gates, pad_last,
                                              pad_lstm_kernel, round_up)

NAME = "fused_lstm_step"
WIDTH_STEP = 32     # the kernel's E and H come in multiples of this
# the kernel (csrc/fused_lstm_step.cu, lstm_step_kernel<U>): 64 rows a
# block, U units a warpgroup (2U a block), one block per SM (H100 SXM: 132)
_ROWS = 64
_UNITS = (64, 32)
_SMS = 132


class StepPlan(NamedTuple):
    """The kernel's launch for (N, E, H).  Block (x, y) of the grid
    computes rows [64x, 64x + 64) and hidden units [2U·y, 2U·y + 2U),
    its warpgroup w the U units from 2U·y + U·w.  The kernel's source
    lays out its shared memory (:func:`lstm_step_layout`)."""

    units: int                  # U: hidden units a warpgroup
    grid: Tuple[int, int]       # (row tiles, unit tiles)


def lstm_step_geometry(N: int, E: int, H: int, units: int) -> StepPlan:
    """The launch at ``units`` per warpgroup."""
    return StepPlan(units, (-(-N // _ROWS), -(-H // (2 * units))))


@functools.lru_cache(maxsize=None)
def lstm_step_plan(N: int, E: int, H: int, sms: int = _SMS) -> StepPlan:
    """U = 32 where the grid at U = 64 would fill under half the SMs
    (fewer blocks re-read more of h, but a half-empty card waits on each
    block's whole stream of W), else U = 64.  At E = 256, H = 512: U = 32
    at N = 512 (32 blocks at U = 64), U = 64 at N = 1536 (96) and 5120
    (320)."""
    wide = lstm_step_geometry(N, E, H, 64)
    if 2 * wide.grid[0] * wide.grid[1] < sms:
        return lstm_step_geometry(N, E, H, 32)
    return wide


def lstm_step_layout(E: int, H: int, units: int) -> Tuple[int, int, int]:
    """(K boxes of A resident at once, ring stages, dynamic shared memory
    in bytes) of the kernel at (E, H, units), from its source (CUDA
    machines only: builds the library)."""
    chunk, stages = ctypes.c_int(0), ctypes.c_int(0)
    smem = _ext.library().vct_fused_lstm_step_layout(
        E, H, units, ctypes.byref(chunk), ctypes.byref(stages))
    return chunk.value, stages.value, smem


def fused_lstm_step_plain(x: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          forget_bias: float = 1.0,
                          reverse_sum: bool = False,
                          plan_rows: Optional[int] = None,
                          operands: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's maths in plain PyTorch: operands rounded to
    ``operands`` (bf16, the kernel's; f32 for the f32 compute path, the
    JAX package's f32 XLA step) and upcast to f32, an f32 matmul, f32 bias
    and gate maths.  ``reverse_sum`` sums each dot product in reverse
    order, the same maths rounded another way.  ``plan_rows`` is the
    wrapper's and changes nothing here."""
    zh = torch.cat([x.to(operands), h.to(operands)], dim=-1).float()
    wf = w.to(operands).float()
    if reverse_sum:
        zh, wf = zh.flip(-1), wf.flip(0)
    gates = zh @ wf + b.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = (torch.sigmoid(f + forget_bias) * c.float()
             + torch.sigmoid(i) * torch.tanh(g))
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def pad_lstm_step(x, c, h, w, b, multiple: int = WIDTH_STEP) -> tuple:
    """(x, c, h, w, b) with E and H zero-padded up to multiples of
    ``multiple``: the operands the kernel takes at any width."""
    E, H = x.shape[1], c.shape[1]
    Ep, Hp = round_up(E, multiple), round_up(H, multiple)
    return (pad_last(x, Ep), pad_last(c, Hp), pad_last(h, Hp),
            pad_lstm_kernel(w, E, H, Ep, Hp), pad_gates(b, H, Hp))


def fused_lstm_step(x: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor,
                    forget_bias: float = 1.0,
                    plan_rows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N,E] bf16, c/h [N,H] f32, w [E+H,4H] bf16, b [4H] f32 →
    (c', h') [N,H] f32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (at E and H padded to multiples of 32) or raise.  No
    backward: raises RuntimeError when grad mode is on and an input
    requires grad.  ``plan_rows`` (default N) is the row count whose plan
    picks the units a warpgroup (:func:`lstm_step_plan`): a share of a
    batch given the whole batch's count sums each row as the whole batch
    does."""
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
    if E % WIDTH_STEP or H % WIDTH_STEP:
        x, c, h, w, b = pad_lstm_step(x, c, h, w, b)
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in (x, c, h, w, b)),
        f"{NAME}: inputs must be contiguous and 16-byte aligned")
    Ep, Hp = x.shape[1], c.shape[1]
    units = lstm_step_plan(plan_rows or N, Ep, Hp,
                           _ext.sm_count(x.device.index)).units
    new_c, new_h = lstm_step_kernel(x, c, h, w, b, forget_bias,
                                    lstm_step_geometry(N, Ep, Hp, units))
    return (new_c, new_h) if Hp == H else (new_c[:, :H], new_h[:, :H])


def lstm_step_kernel(x, c, h, w, b, forget_bias: float, plan: StepPlan
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on checked CUDA operands under ``plan`` (the wrapper's
    :func:`lstm_step_plan`, or another :func:`lstm_step_geometry` to time
    against it)."""
    N, E = x.shape
    H = c.shape[1]
    # c' and h' in one allocation (the step's host time counts: one
    # allocation instead of two)
    out = torch.empty((2, N, H), dtype=torch.float32, device=x.device)
    ptr = out.data_ptr()
    with _ext.device_scope(x.device):
        err = _ext.library().vct_fused_lstm_step(
            x.data_ptr(), c.data_ptr(), h.data_ptr(), w.data_ptr(),
            b.data_ptr(), ptr, ptr + N * H * 4, N, E, H,
            float(forget_bias), plan.units, _ext.stream_ptr(x.device))
    _ext.check_launch(err, NAME)
    _ext.LAUNCHES[NAME] += 1
    new_c, new_h = out.unbind(0)
    return new_c, new_h
