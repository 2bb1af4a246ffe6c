"""Latent-space maths (counterpart of
``vae_captioning_tpu/ops/distributions.py``): reparameterised sampling,
the standard-normal, additive-Gaussian and GMM KLs, the GMM head's
cluster draw, KL annealing, the cluster means and the AG decode-time
prior mean.  The epsilons (1e-5 inside the logs, 1e-7 in the divisors)
are the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# epsilons as in the reference
_EPS_LOG = 1e-5
_EPS_DIV = 1e-7


def sample_gaussian(mean: torch.Tensor, std, num_samples: int,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``num_samples`` reparameterised draws: mean [B, L], std [B, L] or
    a scalar → z [B, K, L] (each image's K samples contiguous, as the JAX
    package keeps them), cast to ``dtype`` when given.  The noise is
    ``eps`` [B, K, L] or is drawn from ``generator``."""
    B, L = mean.shape[0], mean.shape[-1]
    if eps is None:
        eps = torch.randn((B, num_samples, L), generator=generator,
                          device=mean.device, dtype=mean.dtype)
    std = torch.as_tensor(std, dtype=mean.dtype, device=mean.device)
    if std.dim() == 2:
        std = std[:, None, :]
    z = mean[:, None, :] + std * eps
    return z if dtype is None else z.to(dtype)


def _masked_mean(per_example: torch.Tensor,
                 row_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if row_mask is None:
        return per_example.mean()
    row_mask = row_mask.to(per_example.dtype)
    return ((per_example * row_mask).sum()
            / torch.clamp(row_mask.sum(), min=1.0))


def kl_standard_normal(mean: torch.Tensor, std: torch.Tensor,
                       row_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """KL(q(z) || N(0, I)), batch-mean scalar:
    −0.5 · mean_B Σ_L (1 + log(σ² + 1e-5) − μ² − σ²).  ``row_mask``
    excludes padding rows from the mean."""
    inner = (1.0 + torch.log(std.square() + _EPS_LOG)
             - mean.square() - std.square())
    return _masked_mean(-0.5 * inner.sum(dim=-1), row_mask)


def kl_ag(mean: torch.Tensor, std: torch.Tensor, c_v: torch.Tensor,
          cluster_means: torch.Tensor, cluster_sigma: float = 0.1,
          row_mask: Optional[torch.Tensor] = None,
          reduce: str = "mean") -> torch.Tensor:
    """Additive-Gaussian KL: per dimension 0.5 + log(σ_q + 1e-5) −
    log(σ_c + 1e-5) − ((μ_q − c_v·μ_k)² + σ_q²) / (2σ_c² + 1e-7), then
    −0.5 · Σ_dims per example.  ``reduce="mean"`` (the JAX package's
    default) takes the masked mean over rows; ``"sum"`` the masked sum,
    the reference's effective weighting (``Config.ag_kl_sum``).  c_v
    [B, 90], cluster_means [90, L]."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    prior_mean = c_v @ cluster_means
    sig_c = torch.tensor(cluster_sigma, dtype=mean.dtype, device=mean.device)
    inner = (0.5 + torch.log(std + _EPS_LOG) - torch.log(sig_c + _EPS_LOG)
             - ((mean - prior_mean).square() + std.square())
             / (2.0 * sig_c.square() + _EPS_DIV))
    per_example = -0.5 * inner.sum(dim=-1)
    if reduce == "mean":
        return _masked_mean(per_example, row_mask)
    if row_mask is None:
        return per_example.sum()
    return (per_example * row_mask.to(per_example.dtype)).sum()


def gmm_cluster_probs(c_v: torch.Tensor) -> torch.Tensor:
    """The GMM head's cluster law [B, K]: each row of c_v normalised,
    uniform for a row that sums to 0."""
    K = c_v.shape[-1]
    total = c_v.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, c_v / torch.clamp(total, min=1e-9),
                       torch.full_like(c_v, 1.0 / K))


def sample_clusters(c_v: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """One cluster per row [B] (int64) drawn from ``generator``, by the
    JAX package's law ``categorical(log(probs + 1e-9))``: probs + 1e-9,
    renormalised."""
    probs = gmm_cluster_probs(c_v.float()) + 1e-9
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def kl_gmm(mean: torch.Tensor, std: torch.Tensor, c_v: torch.Tensor,
           cluster_means: torch.Tensor, cluster_sigma: float = 0.1,
           row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The GMM-prior KL bound of Hershey & Olsen (``Config.gmm_true_kl``):
    per row −log Σ_k w_k exp(−KL(q ‖ N(μ_k, σ_c² I))), the mixture weights
    w the row's c_v normalised (uniform for an all-zero row), then the
    masked mean over rows.  c_v [B, 90] nonnegative, cluster_means [90, L].
    The component KLs are written as the JAX package writes them: a
    component-independent part plus ‖μ_q − μ_k‖² by the expansion."""
    Kc = cluster_means.shape[0]
    has_any = c_v.sum(dim=-1, keepdim=True) > 0
    w = torch.where(has_any, c_v, torch.full_like(c_v, 1.0 / Kc))
    w = w / w.sum(dim=-1, keepdim=True)
    sig_c = torch.tensor(cluster_sigma, dtype=mean.dtype, device=mean.device)
    var_c = sig_c.square() + _EPS_DIV
    base = (torch.log(sig_c + _EPS_LOG) - torch.log(std + _EPS_LOG)
            + std.square() / (2.0 * var_c) - 0.5).sum(dim=-1)
    d2 = (mean.square().sum(dim=-1, keepdim=True)
          - 2.0 * mean @ cluster_means.t()
          + cluster_means.square().sum(dim=-1)[None, :])
    kl_k = base[:, None] + torch.clamp(d2, min=0.0) / (2.0 * var_c)
    per_example = -torch.logsumexp(torch.log(torch.clamp(w, min=1e-30)) - kl_k,
                                   dim=-1)
    return _masked_mean(per_example, row_mask)


def kl_annealing(step: int, ann_param: float,
                 force_one: bool = False) -> torch.Tensor:
    """The tanh annealing ramp (tanh((step − 1000·ann_param)/1000) + 1)/2
    when ann_param > 1, else 1; ``force_one`` (fine-tune, restore) gives
    1.  Computed in f32, as the JAX package computes it."""
    if force_one or ann_param <= 1.0:
        return torch.tensor(1.0, dtype=torch.float32)
    x = (torch.tensor(float(step), dtype=torch.float32)
         - torch.tensor(1000.0 * ann_param, dtype=torch.float32)) / 1000.0
    return (torch.tanh(x) + 1.0) / 2.0


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
