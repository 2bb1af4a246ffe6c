"""The general generator of the benchmark's inputs: a synthetic COCO-like
corpus from the seed, as a traffic file's parameters describe it.

* fc2 features: ReLU of standard normals (VGG16's fc2 is a ReLU output),
  drawn on the device in one call and kept on the host, where the
  program's feature store serves them;
* cluster vectors [91]: ``detections`` = [least, most] of the 80 used
  COCO category ids an image holds, each weighted 1 / count; a share
  ``no_detection_share`` of the images (every n-th) has none;
* captions: ``captions_per_image`` a image, <BOS> words <EOS>; the word
  counts follow ``caption_words`` (count -> share of captions, given as
  percent), the same multiset for every seed in another order; words are
  drawn Zipf(``zipf_s``) over the vocabulary's word ids.

Every seed gets the same sizes: only which image, caption and word go
where changes.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

PAD, BOS, EOS, UNK = 0, 1, 2, 3
FIRST_WORD = 4
AG_UNUSED_IDS = (0, 12, 26, 29, 30, 45, 66, 68, 69, 71, 83)
CATEGORIES = 91


class Corpus(NamedTuple):
    names: List[str]
    features: np.ndarray                   # [N, F] f32
    cluster_vectors: Dict[str, np.ndarray]  # name -> [91] f32
    cv_array: np.ndarray                    # [N, 91] f32, the same rows
    captions: Dict[str, List[List[int]]]    # name -> token lists
    image_ids: Dict[str, int]


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([seed, salt])


def features(n: int, width: int, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device).manual_seed((seed * 7919 + 17) % 2 ** 63)
    x = torch.randn((n, width), generator=gen, device=device).clamp_(min=0.0)
    return x.cpu().numpy()


def cluster_vectors(n: int, detections, no_detection_share: float,
                    seed: int) -> np.ndarray:
    rng = _rng(seed, 1)
    used = np.array([i for i in range(1, CATEGORIES) if i not in AG_UNUSED_IDS])
    lo, hi = detections
    count = rng.integers(lo, hi + 1, size=n)
    pick = rng.random((n, len(used))).argsort(axis=1)[:, :hi]
    take = np.arange(hi)[None, :] < count[:, None]
    cv = np.zeros((n, CATEGORIES), np.float32)
    rows = np.repeat(np.arange(n), hi).reshape(n, hi)
    cv[rows[take], used[pick[take]]] = 1.0
    cv /= count[:, None].astype(np.float32)
    if no_detection_share > 0:
        cv[::int(round(1.0 / no_detection_share))] = 0.0
    return cv


def caption_lengths(n: int, shares: Dict[str, float], seed: int) -> np.ndarray:
    """Word counts of ``n`` captions: each count's share of ``n`` (percent),
    rounded, the remainder on the most common count; in the seed's order."""
    counts = {int(k): v for k, v in shares.items()}
    total = sum(counts.values())
    per = {k: int(n * v / total) for k, v in counts.items()}
    per[max(counts, key=counts.get)] += n - sum(per.values())
    lengths = np.concatenate([np.full(c, k, np.int64) for k, c in sorted(per.items())])
    return _rng(seed, 2).permutation(lengths)


def captions(n_images: int, per_image: int, vocab_size: int, shares,
             zipf_s: float, seed: int) -> List[List[List[int]]]:
    words = caption_lengths(n_images * per_image, shares, seed)
    ranks = np.arange(1, vocab_size - FIRST_WORD + 1, dtype=np.float64)
    p = ranks ** -zipf_s
    p /= p.sum()
    flat = (_rng(seed, 3).choice(len(p), size=int(words.sum()), p=p)
            + FIRST_WORD).tolist()
    out, at, k = [], 0, 0
    for _ in range(n_images):
        image = []
        for _ in range(per_image):
            w = int(words[k])
            image.append([BOS] + flat[at:at + w] + [EOS])
            at += w
            k += 1
        out.append(image)
    return out


def corpus(traffic: dict, cfg: dict, seed: int, device, split: str) -> Corpus:
    n = traffic["images"]
    names = [f"COCO_{split}_{i:012d}.jpg" for i in range(n)]
    cv = cluster_vectors(n, traffic["detections"],
                         traffic["no_detection_share"], seed)
    caps = captions(n, traffic["captions_per_image"], cfg["vocab_size"],
                    traffic["caption_words"], traffic["zipf_s"], seed)
    return Corpus(names=names,
                  features=features(n, cfg["cnn_feature_size"], seed, device),
                  cluster_vectors=dict(zip(names, cv)), cv_array=cv,
                  captions=dict(zip(names, caps)),
                  image_ids={name: i for i, name in enumerate(names)})


def eps_seed(seed: int, batch: int) -> int:
    """The seed of the z noise of the window's ``batch``-th decode batch."""
    return (seed * 1_000_003 + batch * 7_777_777 + 12345) % 2 ** 63


def decode_eps(seed: int, batch: int, rows: int, width: int, device
               ) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(eps_seed(seed, batch))
    return torch.randn((rows, width), generator=gen, device=device)
