"""Ranks, process groups and batch slicing for data-parallel training
(counterpart of ``vae_captioning_tpu/parallel/mesh.py``).

The JAX package runs one step over a ``dp`` mesh: parameters replicated,
the batch sharded, the gradient sum inserted by pjit.  Here each rank is
one process on its own device, joined by ``torch.distributed``: NCCL
where every rank of a host has a GPU of its own, gloo otherwise (gloo's
collectives go through host copies of CUDA tensors).  Every rank builds
the same seed-deterministic global batch and takes its contiguous rows
(:func:`prepare_process_batch`); the parameters are broadcast from rank
0; the train step sums the gradients of the global loss
(``parallel/kernel_shard.py``).  With no process group this module sees
one rank, and every collective is a no-op.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch
import torch.distributed as dist

T = TypeVar("T")


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init_process_group(rank: int, world: int, init_method: str,
                       device: torch.device | str,
                       backend: Optional[str] = None,
                       local_rank: Optional[int] = None,
                       local_world: Optional[int] = None,
                       timeout: Optional[float] = None) -> torch.device:
    """Join the group of ``world`` ranks at ``init_method``
    (``tcp://host:port``) as ``rank``, and return this rank's device:
    under NCCL ``cuda:<local_rank>``, else ``device``.  ``backend``
    defaults to NCCL where each of the host's ``local_world`` ranks can
    have a GPU of its own, else gloo (NCCL takes one rank a device);
    ``timeout`` (seconds) bounds the rendezvous and every collective
    (torch's default where None)."""
    device = torch.device(device)
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    if backend is None:
        backend = ("nccl" if device.type == "cuda"
                   and torch.cuda.device_count() >= local_world else "gloo")
    if backend == "nccl":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        **({} if timeout is None else {"timeout": timedelta(seconds=timeout)}))
    return device


def initialize_multihost(device: torch.device | str) -> torch.device:
    """Join the process group that ``torchrun`` (``python -m
    torch.distributed.run``) describes in the environment: RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT.
    Returns this rank's device (see :func:`init_process_group`)."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in env]
    if missing:
        raise RuntimeError(f"multihost: {missing} not set; start the ranks "
                           "with torchrun (python -m torch.distributed.run "
                           "--nproc_per_node N -m vae_captioning_torch.cli "
                           "... --set multihost=True)")
    world = int(env["WORLD_SIZE"])
    return init_process_group(
        int(env["RANK"]), world,
        f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", device,
        local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
        local_world=int(env.get("LOCAL_WORLD_SIZE", world)))


def _staged(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether the collectives go through host copies: gloo on CUDA
    tensors."""
    return dist.get_backend() == "gloo" and any(t.is_cuda for t in tensors)


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ranks, in place, in one collective on
    their flattened concatenation (one dtype)."""
    if not dist.is_initialized() or dist.get_world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = flat.cpu() if _staged(tensors) else flat
    dist.all_reduce(staged)
    if staged is not flat:
        flat.copy_(staged)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in place."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for t in tensors:
        staged = t.detach().cpu() if _staged([t]) else t.detach()
        dist.broadcast(staged, src)
        if staged is not t:
            with torch.no_grad():
                t.copy_(staged)


def gather_objects(obj: T) -> List[T]:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [obj]
    out: List = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def rank_zero_first(fn: Callable[[], T]) -> T:
    """``fn()`` on rank 0, then on the other ranks (after a barrier), so
    that caches rank 0 writes are read, not written again, by the rest."""
    rank, world = process_info()
    if world > 1 and rank != 0:
        barrier()
    out = fn()
    if world > 1 and rank == 0:
        barrier()
    return out


def prepare_process_batch(arrays: Sequence[np.ndarray], K: int,
                          n_devices: int, P: int = 1, pid: int = 0):
    """Pure multi-process batch prep: pad, then slice this process's rows.

    ``arrays`` is the flattened train batch
    ``(features[B], enc[B*K], dec[B*K], lengths[B*K], c_v[B])``.
    The image dim ``B`` is padded up to a multiple of ``n_devices`` (the
    global device count) and the caption arrays to ``B' * K``: padding
    the two leading dims independently would break the model's
    K = rows(captions)/rows(features) inference and mispair images with
    captions.  With ``P`` processes, each contributes only its contiguous
    ``B'/P`` image rows (and the matching caption rows); every process
    must have built the same seed-deterministic global batch.

    Raises if the devices do not split evenly over processes, the only
    configuration where ``B' // P`` would drop rows.
    """
    features, enc, dec, lengths, c_v = arrays
    B = int(features.shape[0])
    if enc.shape[0] != B * K or dec.shape[0] != B * K \
            or lengths.shape[0] != B * K:
        raise ValueError(
            f"caption rows {enc.shape[0]} != B*K = {B}*{K}")
    if n_devices % P != 0:
        raise ValueError(
            f"global device count {n_devices} not divisible by process "
            f"count {P}; the dp mesh must span all processes evenly")
    if not (0 <= pid < P):
        raise ValueError(f"process_index {pid} out of range for P={P}")
    Bp = -(-B // n_devices) * n_devices  # n_devices | Bp and P | Bp

    def pad_to(x, rows):
        x = np.asarray(x)
        if x.shape[0] == rows:
            return x
        block = np.zeros((rows - x.shape[0], *x.shape[1:]), x.dtype)
        return np.concatenate([x, block])

    out = (pad_to(features, Bp), pad_to(enc, Bp * K), pad_to(dec, Bp * K),
           pad_to(lengths, Bp * K), pad_to(c_v, Bp))
    if P > 1:
        rows_b = Bp // P
        sl = lambda x, r: x[pid * r:(pid + 1) * r]  # noqa: E731
        out = (sl(out[0], rows_b), sl(out[1], rows_b * K),
               sl(out[2], rows_b * K), sl(out[3], rows_b * K),
               sl(out[4], rows_b))
    return out


def pad_to_multiple(batch_leaf: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading dim up to a multiple of ``multiple`` (the rank
    count) so every rank's share has equal extent."""
    n = batch_leaf.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch_leaf
    pad = multiple - rem
    pad_block = np.zeros((pad, *batch_leaf.shape[1:]), batch_leaf.dtype)
    return np.concatenate([batch_leaf, pad_block])
