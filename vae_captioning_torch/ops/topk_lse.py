"""Exact top-k + logsumexp over materialised f32 logits: CUDA kernel
wrapper and its plain version.

Counterpart of ``top_k_logsumexp_pallas`` in
``vae_captioning_tpu/ops/topk_pallas.py``, the beam search's top-k when
its step writes the [N, V] logits (the step_fn form of
:func:`vae_captioning_torch.ops.decoding.beam_search`, which the decode
takes under ``Config.fused_decode = False``, and the fused decodes' route
for beams wider than their kernels' lists, ``ops/fused_logits_topk.py``).
For each row it returns the k largest values, their column indices with
ties going to the lowest index, and the logsumexp over the row.

On CUDA tensors the wrapper launches ``csrc/topk_lse.cu``: for k <=
``K_LIST`` (32) a persistent grid, one warp streaming a row once and
keeping its list in the lanes; past that (beams of 33 and more: 40 on
the wide-beam path, 100 on small batches) the same file's exact radix
select, one block a row staged in shared memory, which takes any k up to
V (past 512 winners a row, in a workspace the wrapper allocates).  On CPU
tensors it takes the plain version.  The values are copied, so both give
the same values and indices bit for bit; the logsumexp differs by sum
order.  The kernels read x in rows of any pitch (:func:`row_pitch`): the
fused decodes' writer pads its rows to 16 bytes and hands over the
``[N, V]`` view.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vae_captioning_torch import _ext

NAME = "top_k_logsumexp"
K_LIST = 32             # the warp kernel's longest list (csrc/topk_lse.cu)

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties going to the lowest index (the
    order of ``jax.lax.top_k``; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_logsumexp_plain(x: torch.Tensor, k: int) -> Result:
    """The kernel's function in plain PyTorch: a stable sort's first k
    and ``torch.logsumexp``."""
    vals, idx = stable_top_k(x, k)
    return vals, idx.to(torch.int32), torch.logsumexp(x, dim=-1)


def row_pitch(x: torch.Tensor) -> int:
    """The row pitch (floats) at which the kernels read x [N, V]: its row
    stride, V for a single row; ValueError where a row is not contiguous
    or rows overlap."""
    N, V = x.shape
    pitch = x.stride(0) if N > 1 else V
    _ext.require((x.stride(1) == 1 or V == 1) and pitch >= V,
                 f"{NAME}: x's rows must be contiguous and apart, got strides "
                 f"{tuple(x.stride())} at shape {tuple(x.shape)}")
    return pitch


def entry_point(k: int) -> str:
    """The C entry point that takes lists of k: the warp lists up to
    ``K_LIST``, the radix select past them."""
    return "vct_top_k_logsumexp" if k <= K_LIST else "vct_top_k_logsumexp_select"


def top_k_logsumexp(x: torch.Tensor, k: int) -> Result:
    """x [N, V] f32, each row contiguous, rows any pitch apart (a view of
    wider rows) → (values [N, k] f32, indices [N, k] int32, logsumexp
    [N] f32), 1 <= k <= V.  CPU tensors take the plain version; CUDA
    tensors launch the warp lists (k <= K_LIST) or the radix select, or
    raise."""
    _ext.forbid_grad(NAME, x)
    if _ext.on_cpu(x):
        return top_k_logsumexp_plain(x, k)
    req = _ext.require
    req(x.dtype == torch.float32 and x.dim() == 2,
        f"{NAME}: x must be a float32 matrix, got {x.dtype} {tuple(x.shape)}")
    N, V = x.shape
    req(1 <= k <= V, f"{NAME}: k={k} outside [1, V={V}]")
    pitch = row_pitch(x)
    dev = x.device
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    lib, sms = _ext.library(), _ext.sm_count(dev.index)
    outs = (x.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr())
    with _ext.device_scope(dev):
        if entry_point(k) == "vct_top_k_logsumexp":
            err = lib.vct_top_k_logsumexp(*outs, N, V, pitch, k, sms,
                                          _ext.stream_ptr(dev))
        else:
            nbytes = lib.vct_top_k_logsumexp_select_workspace(N, V, k, sms)
            if nbytes < -1:
                _ext.check_launch(-nbytes - 1, NAME)
            req(nbytes >= 0, f"{NAME}: the select's workspace at k={k} "
                "passes 2 GiB")
            work = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
            err = lib.vct_top_k_logsumexp_select(
                *outs, work.data_ptr() if nbytes else None, N, V, pitch, k,
                sms, _ext.stream_ptr(dev))
    _ext.check_launch(err, NAME)
    _ext.LAUNCHES[NAME] += 1
    return vals, idx, lse
