"""Fused logits product + exact top-k + logsumexp: CUDA kernel wrapper
and its plain version.

Counterpart of ``fused_logits_top_k`` in
``vae_captioning_tpu/ops/fused_logits_topk.py``.  For decode hidden
states h it returns the k largest raw logits of ``h @ W + b`` (bias
included), their vocab indices with ties going to the lowest index, and
the logsumexp over the whole vocab.  Beam search normalises only the k
winners; greedy decoding takes k = 1.

On CUDA tensors the wrapper launches ``csrc/fused_logits_topk.cu``
(partial kernel over vocab chunks, then a merge launch), which never
stores the [M, V] logits; on CPU tensors it takes
:func:`fused_logits_top_k_plain`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from vae_captioning_torch import _ext

NAME = "fused_logits_top_k"
K_MAX = 16
_ROWS_PER_BLOCK = 64     # BM of the CUDA kernel
_TILE = 128              # BN: vocab chunks are whole tiles

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties going to the lowest index (the
    order of ``jax.lax.top_k``; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fused_logits_top_k_plain(h: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, k: int,
                             reverse_sum: bool = False) -> Result:
    """The kernel's maths in plain PyTorch: bf16-rounded operands upcast
    to f32, an f32 matmul plus the f32 bias, a stable sort.
    ``reverse_sum`` sums each dot product in reverse order, the same
    maths rounded another way."""
    hf = h.to(torch.bfloat16).float()
    wf = w.to(torch.bfloat16).float()
    if reverse_sum:
        hf, wf = hf.flip(-1), wf.flip(0)
    logits = hf @ wf + b.float()
    vals, idx = stable_top_k(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=-1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_chunks(M: int, V: int, sms: int) -> Tuple[int, int]:
    """(chunk width, number of chunks) for the vocab split: enough blocks
    for about two per SM, each chunk a whole number of 128-column
    tiles."""
    row_blocks = -(-M // _ROWS_PER_BLOCK)
    tiles = -(-V // _TILE)
    want = min(max(1, -(-2 * sms // row_blocks)), tiles)
    chunk_w = -(-tiles // want) * _TILE
    return chunk_w, -(-V // chunk_w)


def fused_logits_top_k(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       k: int) -> Result:
    """h [M,H] bf16, w [H,V] bf16, b [V] f32 → (values [M,k] f32, indices
    [M,k] int32, logsumexp [M] f32), 1 <= k <= 16.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.  No backward:
    raises RuntimeError when grad mode is on and an input requires grad."""
    _ext.forbid_grad(NAME, h, w, b)
    if _ext.on_cpu(h, w, b):
        return fused_logits_top_k_plain(h, w, b, k)
    M, H = h.shape
    V = w.shape[1]
    req = _ext.require
    req(h.dtype == w.dtype == torch.bfloat16 and b.dtype == torch.float32,
        f"{NAME}: h and w must be bfloat16 and b float32, got "
        f"{h.dtype}, {w.dtype}, {b.dtype}")
    req(w.shape[0] == H and b.shape == (V,),
        f"{NAME}: shapes h{tuple(h.shape)} w{tuple(w.shape)} "
        f"b{tuple(b.shape)} disagree")
    req(1 <= k <= min(K_MAX, V), f"{NAME}: k={k} outside [1, {K_MAX}]")
    req(H % 32 == 0, f"{NAME}: H={H} must be a multiple of 32")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (h, w, b)),
        f"{NAME}: inputs must be contiguous and 16-byte aligned")
    dev = h.device
    vals = torch.empty((M, k), dtype=torch.float32, device=dev)
    idx = torch.empty((M, k), dtype=torch.int32, device=dev)
    lse = torch.empty((M,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _ext.library()
        chunk_w, n_chunks = plan_chunks(M, V, _sm_count(dev.index or 0))
        P = n_chunks * lib.vct_logits_top_k_lanes()
        part_vals = torch.empty((P, M, k), dtype=torch.float32, device=dev)
        part_idx = torch.empty((P, M, k), dtype=torch.int32, device=dev)
        part_ms = torch.empty((2, P, M), dtype=torch.float32, device=dev)
        err = lib.vct_fused_logits_top_k(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), part_vals.data_ptr(),
            part_idx.data_ptr(), part_ms[0].data_ptr(), part_ms[1].data_ptr(),
            vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), M, H, V, k,
            chunk_w, n_chunks, _ext.stream_ptr(dev))
    _ext.check_launch(err, NAME)
    _ext.LAUNCHES[NAME] += 1
    return vals, idx, lse
