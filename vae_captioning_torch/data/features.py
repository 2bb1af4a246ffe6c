"""VGG16 fc2 feature storage and batched extraction (counterpart of
``vae_captioning_tpu/data/features.py``).

Features live in one contiguous ``[N, 4096]`` float32 array with a
name→row index, cached per split as ``<cache_dir>/<split>.features.npz``
(the same files the JAX package's extractor writes).
:class:`FeatureExtractor` runs VGG16 on the card over batches of a fixed
size (the last one padded), and :func:`extract_features_from_dir` runs it
over a directory of jpgs when its cache is missing.
"""

from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Optional, Sequence

import numpy as np
import torch


class FeatureStore:
    """Contiguous feature matrix with name-keyed row lookup."""

    def __init__(self, names: Sequence[str], features: np.ndarray):
        if len(names) != features.shape[0]:
            raise ValueError(f"FeatureStore: {len(names)} names for "
                             f"{features.shape[0]} feature rows")
        self.names = [os.path.basename(n) for n in names]
        self.features = np.asarray(features, dtype=np.float32)
        self._row = {n: i for i, n in enumerate(self.names)}

    def __contains__(self, filename: str) -> bool:
        return os.path.basename(filename) in self._row

    def __len__(self) -> int:
        return self.features.shape[0]

    @property
    def feature_size(self) -> int:
        return self.features.shape[1]

    def get_batch(self, filenames: Sequence[str]) -> np.ndarray:
        rows = [self._row[os.path.basename(fn)] for fn in filenames]
        return self.features[rows]

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, names=np.array(self.names), features=self.features)

    @classmethod
    def load(cls, path: str) -> "FeatureStore":
        with np.load(path if path.endswith(".npz") else path + ".npz") as data:
            return cls([str(n) for n in data["names"]], data["features"])

    @classmethod
    def from_reference_pickle(cls, path: str) -> "FeatureStore":
        """Read the reference's ``pickles/<split>.pickle`` {name: [1, 4096]}
        format (ref utils/data.py:100-105) for migration."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        names = sorted(d)
        feats = np.concatenate([np.asarray(d[n]).reshape(1, -1) for n in names])
        return cls(names, feats)

    def merge(self, other: "FeatureStore") -> "FeatureStore":
        return FeatureStore(self.names + other.names,
                            np.concatenate([self.features, other.features]))


class FeatureExtractor:
    """fc2 features of images [N, S, S, 3] (uint8 or f32 RGB, 0..255):
    VGG16 with ``weights_path``'s weights, run on ``device`` (the card
    unless the caller asks for the CPU) over batches of ``batch_size``
    images, the last one padded with zeros, so every launch has one
    shape."""

    def __init__(self, weights_path: str, batch_size: int = 64,
                 compute_dtype: str = "bfloat16",
                 device: torch.device | str = "cuda"):
        from vae_captioning_torch.bridge import load_flax_params
        from vae_captioning_torch.models.finetune import DTYPES
        from vae_captioning_torch.models.vgg16 import VGG16, load_npz_weights

        self.batch_size = batch_size
        self.device = torch.device(device)
        self.model = VGG16(compute_dtype=DTYPES[str(compute_dtype)])
        load_flax_params(self.model, load_npz_weights(weights_path))
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, images: np.ndarray) -> np.ndarray:
        n, bs = len(images), self.batch_size
        out = torch.empty((n, 4096), dtype=torch.float32, device=self.device)
        for start in range(0, n, bs):
            chunk = np.ascontiguousarray(images[start:start + bs])
            if len(chunk) < bs:
                pad = np.zeros((bs - len(chunk), *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            fc2 = self.model(torch.from_numpy(chunk).to(self.device))
            out[start:start + bs] = fc2[:n - start]
        return out.cpu().numpy()


def extract_features_from_dir(
    data_dir: str,
    weights_path: str,
    cache_dir: Optional[str] = None,
    batch_size: int = 64,
    compute_dtype: str = "bfloat16",
    device: torch.device | str = "cuda",
) -> FeatureStore:
    """fc2 features for every jpg in ``data_dir``, from their cache
    ``<cache_dir>/<dirname>.features.npz`` (the reference's per-split
    naming, ref utils/data.py:100-103) or extracted by
    :class:`FeatureExtractor` and cached there."""
    split = os.path.basename(os.path.normpath(data_dir))
    cache_path = None
    if cache_dir:
        cache_path = os.path.join(cache_dir, f"{split}.features.npz")
        if os.path.exists(cache_path):
            return FeatureStore.load(cache_path)
    from vae_captioning_torch.data.images import load_image_batch

    paths = sorted(glob(os.path.join(data_dir, "*.jpg")))
    if not paths:
        raise FileNotFoundError(f"no jpgs in {data_dir}")
    extract = FeatureExtractor(weights_path, batch_size, compute_dtype, device)
    feats = np.concatenate([
        extract(load_image_batch(paths[start:start + batch_size]))
        for start in range(0, len(paths), batch_size)])
    store = FeatureStore(paths, feats)
    if cache_path:
        store.save(cache_path)
    return store


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Extract VGG16 fc2 features for "
                                "a directory of jpgs")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--weights", required=True, help="vgg16_weights.npz path")
    p.add_argument("--cache_dir", default="./cache")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device to run VGG16 on (default: cuda)")
    args = p.parse_args(argv)
    store = extract_features_from_dir(args.data_dir, args.weights,
                                      args.cache_dir, args.batch_size,
                                      device=args.device)
    print(f"extracted {len(store)} feature vectors")


if __name__ == "__main__":
    main()
