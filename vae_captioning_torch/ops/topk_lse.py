"""Exact top-k + logsumexp over materialised f32 logits: CUDA kernel
wrapper and its plain version.

Counterpart of ``top_k_logsumexp_pallas`` in
``vae_captioning_tpu/ops/topk_pallas.py``, the beam search's top-k when
its step writes the [N, V] logits (the step_fn form of
:func:`vae_captioning_torch.ops.decoding.beam_search`, which the decode
takes under ``Config.fused_decode = False``).  For each row it returns
the k largest values, their column indices with ties going to the lowest
index, and the logsumexp over the row.

On CUDA tensors the wrapper launches ``csrc/topk_lse.cu`` (a persistent
grid, one warp streaming a row once); on CPU tensors it takes
:func:`top_k_logsumexp_plain`.  The values are copied, so both give the
same values and indices bit for bit; the logsumexp differs by sum order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.ops.fused_logits_topk import K_MAX, stable_top_k

NAME = "top_k_logsumexp"

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def top_k_logsumexp_plain(x: torch.Tensor, k: int) -> Result:
    """The kernel's function in plain PyTorch: a stable sort's first k
    and ``torch.logsumexp``."""
    vals, idx = stable_top_k(x, k)
    return vals, idx.to(torch.int32), torch.logsumexp(x, dim=-1)


def top_k_logsumexp(x: torch.Tensor, k: int) -> Result:
    """x [N, V] f32 → (values [N, k] f32, indices [N, k] int32, logsumexp
    [N] f32), 1 <= k <= 16.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _ext.forbid_grad(NAME, x)
    if _ext.on_cpu(x):
        return top_k_logsumexp_plain(x, k)
    req = _ext.require
    req(x.dtype == torch.float32 and x.dim() == 2,
        f"{NAME}: x must be a float32 matrix, got {x.dtype} {tuple(x.shape)}")
    N, V = x.shape
    req(1 <= k <= min(K_MAX, V), f"{NAME}: k={k} outside [1, {K_MAX}]")
    req(x.is_contiguous(), f"{NAME}: x must be contiguous")
    dev = x.device
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    with _ext.device_scope(dev):
        err = _ext.library().vct_top_k_logsumexp(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
            N, V, k, _ext.sm_count(dev.index), _ext.stream_ptr(dev))
    _ext.check_launch(err, NAME)
    _ext.LAUNCHES[NAME] += 1
    return vals, idx, lse
