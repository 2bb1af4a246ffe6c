"""Pre-extracted VGG16 fc2 feature storage (the port's copy of
``vae_captioning_tpu/data/features.py``).

Features live in one contiguous ``[N, 4096]`` float32 array with a
name→row index.  The port reads the per-split caches
``<cache_dir>/<split>.features.npz`` that the JAX package's extractor
writes; extracting them here needs the VGG16 model, which is not ported
yet (ROADMAP A.8).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np


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


def extract_features_from_dir(
    data_dir: str,
    weights_path: str,
    cache_dir: Optional[str] = None,
    batch_size: int = 64,
    compute_dtype: str = "bfloat16",
) -> FeatureStore:
    """The fc2 features of every jpg in ``data_dir`` from their cache
    ``<cache_dir>/<dirname>.features.npz`` (the reference's per-split
    naming, ref utils/data.py:100-103).  Without a cache this raises:
    the extraction runs VGG16, which is not ported yet."""
    split = os.path.basename(os.path.normpath(data_dir))
    if cache_dir:
        cache_path = os.path.join(cache_dir, f"{split}.features.npz")
        if os.path.exists(cache_path):
            return FeatureStore.load(cache_path)
    raise NotImplementedError(
        f"not ported yet: VGG16 feature extraction for {data_dir} "
        f"(no cache {split}.features.npz in {cache_dir!r}): ROADMAP A.8")
