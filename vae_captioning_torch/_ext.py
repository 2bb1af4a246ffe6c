"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, at first use, into
``_build/`` beside this file: one ``nvcc -shared`` per source, all
started together.  A library's name carries a hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited kernel or
header is rebuilt and a built one is reused.
The libraries are loaded with ctypes; every C entry point returns a
``cudaError_t`` that :func:`check_launch` turns into an exception.

Nothing here runs when the package is imported: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel, so a run can show that its main path went through the kernels.
LAUNCHES: Dict[str, int] = {
    "fused_lstm_step": 0, "fused_logits_top_k": 0,
    "fused_lstm_seq_fwd": 0, "fused_lstm_seq_bwd": 0,
    "fused_z_fwd": 0, "fused_z_bwd": 0, "fused_z_eps": 0,
    "fused_ag_heads_fwd": 0, "fused_ag_heads_bwd": 0,
    "fused_linear_ce_fwd": 0, "fused_linear_ce_dh": 0,
    "fused_linear_ce_dwdb": 0, "fused_logits_top_k_int8": 0,
    "fused_logits_sample": 0, "top_k_logsumexp": 0,
    "fused_linear_ce_mat_fwd": 0, "fused_linear_ce_mat_dh": 0,
    "fused_linear_ce_mat_dwdb": 0}

_lib: Optional[SimpleNamespace] = None
# Seconds the first library() call spent compiling (0.0 when every
# library for these sources was already built), and nvcc's output
# (register and shared-memory use per kernel, from -Xptxas=-v).
build_seconds: Optional[float] = None
build_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGNATURES = {
    "vct_fused_lstm_step": [_P] * 7 + [_I] * 3 + [ctypes.c_float, _I, _P],
    "vct_fused_lstm_step_layout": [_I] * 3 + [_P] * 2,
    "vct_fused_logits_top_k": [_P] * 10 + [_I] * 8 + [_P],
    "vct_fused_logits_top_k_int8": [_P] * 12 + [_I] * 8 + [_P],
    "vct_fused_logits_write": [_P] * 4 + [_I] * 8 + [_P],
    "vct_fused_logits_write_int8": [_P] * 6 + [_I] * 8 + [_P],
    "vct_fused_logits_sample": [_P] * 7 + [_I] * 3 + [_U, _U, ctypes.c_float]
                               + [_I] * 5 + [_P],
    "vct_fused_logits_top_k_smem": [_I] * 4,
    "vct_fused_logits_write_smem": [_I] * 4,
    "vct_fused_logits_top_k_block": [_I] * 4,
    "vct_top_k_logsumexp": [_P] * 4 + [_I] * 5 + [_P],
    "vct_top_k_logsumexp_select": [_P] * 5 + [_I] * 5 + [_P],
    "vct_top_k_logsumexp_select_workspace": [_I] * 4,
    "vct_top_k_logsumexp_select_smem": [_I],
    "vct_fused_lstm_seq_fwd": [_P] * 12 + [_I] * 4 + [_P],
    "vct_fused_lstm_seq_bwd": [_P] * 21 + [_I] * 8 + [_P],
    "vct_fused_lstm_seq_fwd_smem": [],
    "vct_fused_lstm_seq_bwd_smem": [_I, _I],
    "vct_fused_lstm_seq_dw_smem": [_I],
    "vct_fused_z_fwd": [_P] * 6 + [_I] * 9 + [_U, _U, _P],
    "vct_fused_z_bwd": [_P] * 8 + [_I] * 9 + [_U, _U, _P],
    "vct_fused_z_smem": [_I, _I],
    "vct_fused_z_transform_check": [_P, _P],
    "vct_fused_z_eps": [_P] + [_I] * 3 + [_U, _U, _I, _I, _P],
    "vct_fused_ag_heads_fwd": [_P] * 6 + [_I] * 6 + [_P],
    "vct_fused_ag_heads_fwd_smem": [_I, _I],
    "vct_fused_ag_heads_bwd": [_P] * 7 + [_I] + [_P] * 7 + [_I] * 8 + [_P],
    "vct_fused_ag_heads_mat_smem": [_I],
    "vct_fused_ce_fwd": [_P] * 7 + [_I] * 4 + [_P],
    "vct_fused_ce_dh": [_P] * 7 + [_I] * 3 + [_P],
    "vct_fused_ce_dwdb": [_P] * 10 + [_I] * 5 + [_P],
    "vct_fused_ce_fwd_smem": [_I, _I],
    "vct_fused_ce_fwd_block": [_I, _I],
    "vct_fused_ce_bwd_smem": [_I],
    "vct_fused_ce_bwd_cluster": [_I],
    "vct_fused_ce_bwd_cluster_slots": [],
    "vct_fused_ce_bwd_cluster_launches": [],
    "vct_fused_ce_fwd_cluster": [_I, _I],
    "vct_fused_ce_fwd_cluster_slots": [],
    "vct_fused_ce_fwd_cluster_launches": [],
    "vct_fused_ce_mat_fwd_cluster_launches": [],
    "vct_fused_ce_mat_fwd": [_P] * 8 + [_I] * 4 + [_P],
    "vct_fused_ce_mat_dh": [_P] * 6 + [_I] * 3 + [_P],
    "vct_fused_ce_mat_dwdb": [_P] * 9 + [_I] * 5 + [_P],
    "vct_fused_ce_mat_bwd_smem": [_I],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "vae_captioning_torch are built from csrc/ at first use")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(src: Path) -> Path:
    """The library built from ``src``; its name hashes the flags, the
    source and every shared header in ``csrc/``, so an edited header
    rebuilds the libraries that may include it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def _build() -> list:
    """Compile every source whose library is missing, one nvcc each, all
    started together; returns every source's library path."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, tmp, out, proc in jobs:
        logs.append(f"$ {' '.join(cmd)}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(cmd[-1])
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0 if jobs else 0.0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    return [library_path(src) for src in _sources()]


def library() -> SimpleNamespace:
    """The kernels' C entry points, by name; built on the first call."""
    global _lib
    if _lib is None:
        libs = [ctypes.CDLL(str(path)) for path in _build()]
        fns = {}
        for name, argtypes in _SIGNATURES.items():
            fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _lib = SimpleNamespace(**fns)
    return _lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes its
    plain version), False when all lie on one CUDA device (the wrapper
    launches its kernel).  Anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError("tensors must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(str(d) for d in devices)}")


def forbid_grad(name: str, *tensors: torch.Tensor) -> None:
    """Inference kernels have no backward, and their outputs, written
    through ``data_ptr()``, would be cut off from autograd.  Their
    wrappers call this on every device, the CPU included, so the CPU
    tests see what the card would do: RuntimeError when grad mode is on
    and an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is an inference kernel with no backward: call it "
            "under torch.no_grad() / torch.inference_mode(), or use its "
            "plain version for a differentiable step")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# the current stream as a raw pointer, where torch's C binding has it: a
# Stream object costs several microseconds a call, the decode step's budget
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(torch.cuda.current_device() if device.index is None
                           else device.index)
    return torch.cuda.current_stream(device).cuda_stream


def device_scope(device: torch.device):
    """``torch.cuda.device(device)`` where another device is current, else
    a context that does nothing (it costs microseconds a call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
