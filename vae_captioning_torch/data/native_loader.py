"""ctypes bindings for the native batch loader plus the packed raw record
format (the port's copy of ``vae_captioning_tpu/data/native_loader.py``).

``RawImageStore`` is a drop-in alternative to ``Hdf5ImageStore`` (same
``get_batch``) backed by a memory-mapped flat uint8 file and a C++
thread-pool gather with next-batch prefetch: the fine-tune input
pipeline's native fast path.  ``pack_images_to_raw`` is the matching
packer.

The library is the port's own copy of the loader,
``vae_captioning_torch/native/batchloader.cpp``, built with g++ at first
use into ``vae_captioning_torch/_build/`` (its name hashes the source and
the flags, so an edited source is rebuilt).  Without a toolchain the
store falls back to a numpy memmap; ``RawImageStore.loader`` says which
one serves the batches, and ``build_error`` why the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
from glob import glob
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "batchloader.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbatchloader_{digest.hexdigest()[:16]}.so"


def _build_library() -> Optional[Path]:
    global build_error
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        build_error = f"g++ not found: {e}"
        return None
    except subprocess.CalledProcessError as e:
        build_error = f"g++ failed:\n{e.stderr}"
        return None
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def load_library():
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.bl_open.restype = ctypes.c_void_p
    lib.bl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int]
    lib.bl_gather.restype = ctypes.c_int
    lib.bl_gather.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_int64, ctypes.c_void_p]
    lib.bl_prefetch.restype = ctypes.c_int
    lib.bl_prefetch.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_int64]
    lib.bl_num_records.restype = ctypes.c_int64
    lib.bl_num_records.argtypes = [ctypes.c_void_p]
    lib.bl_close.restype = None
    lib.bl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


# ----------------------------------------------------------------------
# packed raw record format: <name>.bin (N * record flat uint8) +
# <name>.bin.meta.json {record_shape, dtype, names→row}
# ----------------------------------------------------------------------

def write_raw(images: np.ndarray, names: Sequence[str], output_bin: str
              ) -> Dict[str, int]:
    """Write uint8 images [N, H, W, 3] and their file names in the raw
    record format."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or len(names) != images.shape[0]:
        raise ValueError(f"write_raw: {len(names)} names for images of shape "
                         f"{images.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(output_bin)), exist_ok=True)
    images.tofile(output_bin)
    name_to_row = {os.path.basename(n): i for i, n in enumerate(names)}
    meta = {"record_shape": list(images.shape[1:]), "dtype": "uint8",
            "names": name_to_row}
    with open(output_bin + ".meta.json", "w") as f:
        json.dump(meta, f)
    return name_to_row


def pack_images_to_raw(image_dirs: Sequence[str], output_bin: str,
                       size: int = 224) -> Dict[str, int]:
    """Pack every jpg into one flat uint8 record file."""
    from vae_captioning_torch.data.images import load_image

    paths = []
    for d in image_dirs:
        paths.extend(sorted(glob(os.path.join(d, "*.jpg"))))
    if not paths:
        raise FileNotFoundError(f"no jpgs under {image_dirs}")
    os.makedirs(os.path.dirname(os.path.abspath(output_bin)), exist_ok=True)
    name_to_row: Dict[str, int] = {}
    with open(output_bin, "wb") as f:
        for i, p in enumerate(paths):
            f.write(load_image(p, size).astype(np.uint8).tobytes())
            name_to_row[os.path.basename(p)] = i
    meta = {"record_shape": [size, size, 3], "dtype": "uint8",
            "names": name_to_row}
    with open(output_bin + ".meta.json", "w") as f:
        json.dump(meta, f)
    return name_to_row


class RawImageStore:
    """mmap + native thread-pool gather over a packed raw record file."""

    def __init__(self, bin_path: str, num_threads: int = 8,
                 force_numpy: bool = False):
        with open(bin_path + ".meta.json") as f:
            meta = json.load(f)
        self.record_shape = tuple(meta["record_shape"])
        self.name_to_row: Dict[str, int] = meta["names"]
        self._record_size = int(np.prod(self.record_shape))
        self._n = len(self.name_to_row)
        self._handle = None
        self._lib = None if force_numpy else load_library()
        if self._lib is not None:
            self._handle = self._lib.bl_open(
                bin_path.encode(), self._n, self._record_size, num_threads)
            if not self._handle:
                self._lib = None
        if self._lib is None:  # numpy mmap fallback
            self._mm = np.memmap(bin_path, dtype=np.uint8, mode="r",
                                 shape=(self._n, *self.record_shape))

    @property
    def loader(self) -> str:
        """"native" (the C++ gather) or "numpy" (the memmap fallback)."""
        return "numpy" if self._lib is None else "native"

    def __len__(self) -> int:
        return self._n

    def _rows(self, filenames: Sequence[str]) -> np.ndarray:
        return np.asarray(
            [self.name_to_row[os.path.basename(f)] for f in filenames],
            dtype=np.int64)

    def get_batch(self, filenames: Sequence[str]) -> np.ndarray:
        """Gather images as uint8 [B, H, W, 3]: raw pixels stay one byte a
        channel through host batching and the host → device copy (4x less
        traffic than f32); VGG16 subtracts the mean in f32 on the device."""
        rows = self._rows(filenames)
        if self._lib is not None:
            out = np.empty((len(rows), *self.record_shape), np.uint8)
            rc = self._lib.bl_gather(
                self._handle,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(rows), out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"bl_gather failed with code {rc}")
            return out
        return np.asarray(self._mm[rows])

    def prefetch(self, filenames: Sequence[str]) -> None:
        """Warm the page cache for an upcoming batch (no-op on fallback)."""
        if self._lib is None:
            return
        rows = self._rows(filenames)
        self._lib.bl_prefetch(
            self._handle, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(rows))

    def close(self) -> None:
        if self._lib is not None and self._handle:
            self._lib.bl_close(self._handle)
            self._handle = None


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Pack COCO jpgs into the raw "
                                "record format for the native loader")
    p.add_argument("--image_dirs", nargs="+", required=True)
    p.add_argument("--output", required=True, help="output .bin path")
    args = p.parse_args(argv)
    index = pack_images_to_raw(args.image_dirs, args.output)
    print(f"packed {len(index)} images into {args.output}")


if __name__ == "__main__":
    main()
