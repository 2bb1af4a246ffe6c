"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into ``_build/``
beside this file.  The library's name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a built one is reused.  It is
loaded with ctypes; every C entry point returns a ``cudaError_t`` that
:func:`check_launch` turns into an exception.

Nothing here runs when the package is imported: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel, so a run can show that its main path went through the kernels.
LAUNCHES: Dict[str, int] = {"fused_lstm_step": 0, "fused_logits_top_k": 0}

_lib: Optional[ctypes.CDLL] = None
# Seconds the first library() call spent compiling (0.0 when the library
# for these sources was already built), and nvcc's output (register and
# shared-memory use per kernel, from -Xptxas=-v).
build_seconds: Optional[float] = None
build_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vct_fused_lstm_step": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            ctypes.c_float, _P],
    "vct_fused_logits_top_k": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P],
    "vct_logits_top_k_lanes": [],
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
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvct_kernels_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
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


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
