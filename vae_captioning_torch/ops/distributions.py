"""Decode-time latent-space maths (counterpart of the decode half of
``vae_captioning_tpu/ops/distributions.py``).

The KL terms and ``sample_gaussian`` belong to training and wait for
the train-step slice.
"""

from __future__ import annotations

import numpy as np
import torch

# unused COCO category ids within 0..90, in the *91-dim* id space
# (ref vae_model/decoder.py:56 — blacklist for the AG decode-time prior)
AG_UNUSED_CLASSES = (0, 12, 26, 29, 30, 45, 66, 68, 69, 71, 83)


def init_cluster_means(num_clusters: int, latent_size: int,
                       seed: int = 0) -> np.ndarray:
    """Unit-norm random cluster means [num_clusters, latent_size]: the
    same numpy draw as the reference, so the same seed gives the same
    array (the reference model fixes them from ``Config.seed``)."""
    rng = np.random.default_rng(seed)
    m = 2.0 * rng.random((num_clusters, latent_size)) - 1.0
    m /= np.sqrt((m ** 2).sum(axis=1, keepdims=True))
    return m.astype(np.float32)


def ag_prior_mean(c_v: torch.Tensor, cluster_means: torch.Tensor
                  ) -> torch.Tensor:
    """Decode-time AG prior mean [B, L]: the mean of the cluster means
    whose c_v entry is positive, or, for an image with no detection, the
    mean over all used classes.  c_v: [B, 90] (index 0 already dropped),
    cluster_means: [90, L]."""
    active = (c_v > 0).to(cluster_means.dtype)
    used = torch.ones(cluster_means.shape[0], dtype=cluster_means.dtype,
                      device=cluster_means.device)
    for cls in AG_UNUSED_CLASSES:
        idx = cls - 1  # shift into the 90-dim space (c_v[:, 1:])
        if 0 <= idx < used.shape[0]:
            used[idx] = 0.0
    has_any = active.sum(dim=-1, keepdim=True) > 0
    weights = torch.where(has_any, active, used[None, :])
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights @ cluster_means
