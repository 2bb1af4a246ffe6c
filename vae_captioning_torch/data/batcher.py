"""Batching engine: filenames + indexed captions → fixed-shape arrays
(the port's copy of ``vae_captioning_tpu/data/batcher.py``).

Replaces ``utils/batch_gen.py`` (Batch_Generator) and
``utils/caption_utils.py`` (K-caption flattening).  Differences are all
TPU-motivated:

  * **Static shapes.** Captions are padded to a *bucketed* length (next
    multiple of ``bucket_multiple``), so XLA compiles a handful of shapes
    instead of one per batch.  Trailing partial batches are padded to the
    full batch size and carry a validity count.
  * **Split semantics preserved.** ``<BOS> w… / w… <EOS>`` decoder-input /
    label split (ref ``utils/batch_gen.py:326-331``), random caption
    choice when ``num_captions == 1`` else the first K captions
    (ref ``:323-331``), zero-vector cluster fallback, repartition of
    val2014 into the train pool keeping the last ``gen_val_cap`` images
    for generation (ref ``:71-96``).
  * **Deterministic.** One ``np.random.Generator`` seeded from config
    (the reference seeds numpy but not ``random.shuffle``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from vae_captioning_torch.data.cluster_vectors import lookup_batch


@dataclass
class Batch:
    """One fixed-shape training/eval batch.

    dec_inputs / labels are ``[B, K, T]`` (K = captions per image); the
    model flattens to ``[B*K, T]`` and tiles features on device
    (ref main.py:84-89 tiling + caption_utils.py flattening).
    ``valid`` counts real examples; rows >= valid are padding.
    """

    features: np.ndarray            # [B, 4096] float32 (or images [B,224,224,3])
    dec_inputs: np.ndarray          # [B, K, T] int32, starts with <BOS>
    labels: np.ndarray              # [B, K, T] int32, ends with <EOS>
    lengths: np.ndarray             # [B, K] int32, real token count per row
    cluster_vectors: np.ndarray     # [B, 90] float32 (index 0 already dropped)
    image_ids: Optional[np.ndarray] = None  # [B] int64 (val/test)
    valid: int = 0                  # number of non-padding examples
    cv_fallbacks: int = 0           # images served the zero cluster vector

    @property
    def batch_size(self) -> int:
        return self.dec_inputs.shape[0]

    @property
    def num_captions(self) -> int:
        return self.dec_inputs.shape[1]


def bucket_length(max_len: int, multiple: int, cap: Optional[int] = None) -> int:
    b = ((max(int(max_len), 1) + multiple - 1) // multiple) * multiple
    return min(b, cap) if cap else b


class CaptionBatcher:
    """Iterates filename pools into fixed-shape batches."""

    def __init__(
        self,
        filenames: Sequence[str],
        captions_indexed: Dict[str, List[List[int]]],
        batch_size: int,
        *,
        extra_captions: Optional[Dict[str, List[List[int]]]] = None,
        feature_store=None,            # FeatureStore-like (get_batch)
        image_store=None,              # Hdf5ImageStore / dir loader for fine-tune
        cluster_vectors: Optional[Dict[str, np.ndarray]] = None,
        filename_to_imid: Optional[Dict[str, int]] = None,
        bucket_multiple: int = 8,
        cap_max_length: int = 100,
        seed: int = 42,
    ):
        if not filenames:
            raise FileNotFoundError("empty filename pool — check COCO dir")
        self.filenames = list(filenames)
        self.captions = captions_indexed
        self.extra_captions = extra_captions or {}
        self.batch_size = batch_size
        self.feature_store = feature_store
        self.image_store = image_store
        self.cluster_vectors = cluster_vectors
        self.filename_to_imid = filename_to_imid or {}
        self.bucket_multiple = bucket_multiple
        self.cap_max_length = cap_max_length
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def _caps_for(self, filename: str) -> List[List[int]]:
        key = os.path.basename(filename)
        caps = self.captions.get(key)
        if not caps:
            caps = self.extra_captions.get(key)
        if not caps:
            raise KeyError(f"no captions for {key}")
        return caps

    def _images_for(self, batch_files: List[str]) -> np.ndarray:
        if self.feature_store is not None:
            return self.feature_store.get_batch(batch_files)
        if self.image_store is not None:
            return self.image_store.get_batch(batch_files)
        from vae_captioning_torch.data.images import load_image_batch
        return load_image_batch(batch_files)

    def _cluster_for(self, batch_files: List[str]) -> Tuple[np.ndarray, int]:
        vecs, n_fallbacks = lookup_batch(self.cluster_vectors, batch_files)
        # drop index 0 (ref ops/inference.py:21, main.py:236)
        return vecs[:, 1:], n_fallbacks

    def _ids_for(self, batch_files: List[str]) -> np.ndarray:
        return np.asarray(
            [self.filename_to_imid.get(os.path.basename(f), -1)
             for f in batch_files], dtype=np.int64)

    # ------------------------------------------------------------------
    def _form_captions(self, batch_files: List[str], num_captions: int,
                       pad_rows: int = 0):
        """Caption arrays for a batch (ref utils/batch_gen.py:296-345).

        num_captions == 1 → one random caption per image; else the first K.
        Rows an image can't fill stay empty (length 0, all-PAD) exactly as
        the reference leaves them — they contribute nothing to the masked
        loss.
        """
        random_select = num_captions == 1
        rows: List[List[List[int]]] = []
        for fn in batch_files:
            caps = self._caps_for(fn)
            if random_select:
                chosen = [caps[int(self.rng.integers(len(caps)))]]
            else:
                chosen = caps[:num_captions]
            rows.append([c[: self.cap_max_length] for c in chosen])

        max_len = max((len(c) - 1 for image in rows for c in image), default=1)
        T = bucket_length(max_len, self.bucket_multiple, self.cap_max_length)
        B = len(batch_files) + pad_rows
        K = num_captions
        dec = np.zeros((B, K, T), dtype=np.int32)
        lab = np.zeros((B, K, T), dtype=np.int32)
        lengths = np.zeros((B, K), dtype=np.int32)
        for i, image in enumerate(rows):
            for k, cap in enumerate(image[:K]):
                n = min(len(cap) - 1, T)
                if n <= 0:
                    continue
                dec[i, k, :n] = cap[:n]          # <BOS> w1 ... (ref :329)
                lab[i, k, :n] = cap[1: n + 1]    # w1 ... <EOS> (ref :330)
                lengths[i, k] = n
        return dec, lab, lengths

    # ------------------------------------------------------------------
    def _emit(self, batch_files: List[str], num_captions: int,
              with_ids: bool, pad_to_full: bool) -> Batch:
        valid = len(batch_files)
        pad_rows = self.batch_size - valid if pad_to_full else 0
        dec, lab, lengths = self._form_captions(batch_files, num_captions,
                                                pad_rows)
        images = self._images_for(batch_files)
        if pad_rows:
            images = np.concatenate(
                [images, np.zeros((pad_rows, *images.shape[1:]),
                                  dtype=images.dtype)])
        cvecs, cv_fallbacks = self._cluster_for(batch_files)
        if pad_rows:
            cvecs = np.concatenate(
                [cvecs, np.zeros((pad_rows, cvecs.shape[1]),
                                 dtype=cvecs.dtype)])
        ids = None
        if with_ids:
            ids = self._ids_for(batch_files)
            if pad_rows:
                ids = np.concatenate([ids, -np.ones(pad_rows, dtype=np.int64)])
        return Batch(features=images, dec_inputs=dec, labels=lab,
                     lengths=lengths, cluster_vectors=cvecs,
                     image_ids=ids, valid=valid, cv_fallbacks=cv_fallbacks)

    # ------------------------------------------------------------------
    def train_batches(self, num_captions: int = 1,
                      drop_remainder: bool = True) -> Iterator[Batch]:
        """One shuffled epoch (ref utils/batch_gen.py:164-205).

        When the image store supports it (native loader), the NEXT
        batch's pages are prefetched while the current one is built, so
        fine-tune steps never wait on cold page-cache reads."""
        order = self.rng.permutation(len(self.filenames))
        files = [self.filenames[i] for i in order]
        limit = len(files) - (len(files) % self.batch_size if drop_remainder else 0)
        prefetch = getattr(self.image_store, "prefetch", None)
        for start in range(0, limit, self.batch_size):
            chunk = files[start:start + self.batch_size]
            if prefetch is not None:
                nxt = files[start + self.batch_size:
                            start + 2 * self.batch_size]
                if nxt:
                    prefetch(nxt)
            yield self._emit(chunk, num_captions, with_ids=False,
                             pad_to_full=True)

    def eval_batches(self, num_captions: int = 1,
                     with_ids: bool = True) -> Iterator[Batch]:
        """Deterministic sweep with final partial batch padded
        (ref utils/batch_gen.py:215-255)."""
        for start in range(0, len(self.filenames), self.batch_size):
            chunk = self.filenames[start:start + self.batch_size]
            yield self._emit(chunk, num_captions, with_ids=with_ids,
                             pad_to_full=True)

    def image_batches(self, with_ids: bool = True) -> Iterator[Batch]:
        """Caption-less sweep (test split, ref utils/batch_gen.py:257-276)."""
        for start in range(0, len(self.filenames), self.batch_size):
            chunk = self.filenames[start:start + self.batch_size]
            valid = len(chunk)
            pad_rows = self.batch_size - valid
            images = self._images_for(chunk)
            cvecs, cv_fallbacks = self._cluster_for(chunk)
            if pad_rows:
                images = np.concatenate(
                    [images, np.zeros((pad_rows, *images.shape[1:]),
                                      dtype=images.dtype)])
                cvecs = np.concatenate(
                    [cvecs, np.zeros((pad_rows, cvecs.shape[1]),
                                     dtype=cvecs.dtype)])
            ids = self._ids_for(chunk) if with_ids else None
            if ids is not None and pad_rows:
                ids = np.concatenate([ids, -np.ones(pad_rows, dtype=np.int64)])
            T = 1
            dummy = np.zeros((self.batch_size, 1, T), dtype=np.int32)
            yield Batch(features=images, dec_inputs=dummy, labels=dummy,
                        lengths=np.zeros((self.batch_size, 1), dtype=np.int32),
                        cluster_vectors=cvecs, image_ids=ids, valid=valid,
                        cv_fallbacks=cv_fallbacks)


def repartition(
    train_files: List[str],
    val_files: List[str],
    gen_val_cap: Optional[int],
    rng: np.random.Generator,
):
    """Fold val2014 images into the train pool, keeping the last
    ``gen_val_cap`` (after a shuffle) as the generation/val split
    (ref utils/batch_gen.py:71-96).

    Returns (train_pool, heldout_val).
    """
    shuffled = list(val_files)
    rng.shuffle(shuffled)
    if gen_val_cap is not None and gen_val_cap < 0:
        gen_val_cap = None
    if gen_val_cap:
        return train_files + shuffled[:-gen_val_cap], shuffled[-gen_val_cap:]
    return train_files + shuffled, []
