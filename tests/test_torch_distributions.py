"""Latent maths of the port against the JAX package: the seed-fixed
cluster means, the AG prior mean, the AG and GMM KLs, and the law of the
GMM head's cluster draw."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_captioning_tpu.ops import distributions as jdist
from vae_captioning_torch.ops import distributions as tdist


@pytest.mark.parametrize("shape_seed", [(90, 150, 42), (90, 16, 0), (7, 3, 5)])
def test_cluster_means_are_the_same_draw(shape_seed):
    K, L, seed = shape_seed
    got = tdist.init_cluster_means(K, L, seed)
    np.testing.assert_array_equal(got, jdist.init_cluster_means(K, L, seed))
    assert got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


def test_ag_prior_mean_matches_jax():
    """Active clusters average their means; an image with no detection
    takes the mean over the used classes (the blacklist shifted into the
    90-dim c_v space)."""
    rng = np.random.default_rng(0)
    means = tdist.init_cluster_means(90, 16, 3)
    c_v = (rng.random((6, 90)) * (rng.random((6, 90)) < 0.1)).astype(np.float32)
    c_v[0] = 0.0
    c_v[1] = 0.0
    c_v[1, 11] = 0.7                # class id 12: blacklisted, but active
    got = tdist.ag_prior_mean(torch.from_numpy(c_v), torch.from_numpy(means))
    want = jdist.ag_prior_mean(jnp.asarray(c_v), jnp.asarray(means))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), means[11], rtol=1e-6)
    assert tdist.AG_UNUSED_CLASSES == jdist.AG_UNUSED_CLASSES


@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("masked", [False, True])
def test_kl_ag_matches_jax(reduce, masked):
    """With and without a row mask, meaned and summed over rows; one row
    has an all-zero cluster vector.  f32 sums in another order: 1e-6."""
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(6, 16)).astype(np.float32)
    std = rng.uniform(0.05, 2.0, size=(6, 16)).astype(np.float32)
    c_v = (rng.random((6, 90)) * (rng.random((6, 90)) < 0.1)).astype(np.float32)
    c_v[2] = 0.0
    means = tdist.init_cluster_means(90, 16, 3)
    mask = np.array([1, 0, 1, 1, 0, 1], bool) if masked else None
    got = tdist.kl_ag(*(torch.from_numpy(a) for a in (mean, std, c_v, means)),
                      0.1, None if mask is None else torch.from_numpy(mask),
                      reduce=reduce)
    want = jdist.kl_ag(*(jnp.asarray(a) for a in (mean, std, c_v, means)),
                       0.1, None if mask is None else jnp.asarray(mask),
                       reduce=reduce)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_kl_ag_rejects_an_unknown_reduction():
    x = torch.ones(2, 3)
    with pytest.raises(ValueError, match="reduce"):
        tdist.kl_ag(x, x, torch.ones(2, 4), torch.ones(4, 3), reduce="max")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sigma", [0.1, 0.7])
def test_kl_gmm_matches_jax(masked, sigma):
    """With and without a row mask; two rows have all-zero cluster
    vectors (uniform weights), one row a single active cluster.  f32 sums
    in another order, through a logsumexp over 90 components: 1e-5."""
    rng = np.random.default_rng(7)
    mean = rng.normal(0, 0.5, size=(8, 16)).astype(np.float32)
    std = rng.uniform(0.05, 1.5, size=(8, 16)).astype(np.float32)
    c_v = (rng.random((8, 90)) * (rng.random((8, 90)) < 0.1)).astype(np.float32)
    c_v[2] = 0.0
    c_v[5] = 0.0
    c_v[6] = 0.0
    c_v[6, 40] = 1.0
    means = tdist.init_cluster_means(90, 16, 3)
    mask = np.array([1, 0, 1, 1, 1, 0, 1, 1], bool) if masked else None
    got = tdist.kl_gmm(*(torch.from_numpy(a) for a in (mean, std, c_v, means)),
                       sigma, None if mask is None else torch.from_numpy(mask))
    want = jdist.kl_gmm(*(jnp.asarray(a) for a in (mean, std, c_v, means)),
                        sigma, None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_gmm_cluster_probs_follow_c_v():
    c_v = torch.tensor([[0.0, 2.0, 0.0, 2.0], [0.0, 0.0, 0.0, 0.0],
                        [1.0, 0.0, 0.0, 0.0]])
    want = torch.tensor([[0.0, 0.5, 0.0, 0.5], [0.25] * 4, [1.0, 0.0, 0.0, 0.0]])
    torch.testing.assert_close(tdist.gmm_cluster_probs(c_v), want)


def test_cluster_draws_follow_the_law():
    """The GMM head's draws over many rows against probs: total variation
    below 0.01 per image (about 0.003 expected at 40,000 draws of 6
    clusters), the uniform fallback for an all-zero c_v included; a
    cluster of weight 0 is drawn at most at its 1e-9 share."""
    c_v = torch.tensor([[0.0, 1.0, 0.0, 1.0, 2.0, 0.0],
                        [0.0] * 6,
                        [5.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                        [0.0, 0.0, 0.0, 0.0, 0.0, 3.0]])
    n = 40_000
    g = torch.Generator().manual_seed(0)
    draws = tdist.sample_clusters(c_v.repeat_interleave(n, dim=0), g)
    assert draws.dtype == torch.int64 and draws.shape == (4 * n,)
    probs = tdist.gmm_cluster_probs(c_v)
    for i in range(4):
        freq = torch.bincount(draws[i * n:(i + 1) * n], minlength=6).double() / n
        assert 0.5 * float((freq - probs[i].double()).abs().sum()) < 0.01, i
        assert bool((freq[probs[i] == 0] == 0).all()), i
    again = tdist.sample_clusters(c_v.repeat_interleave(n, dim=0),
                                  torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)        # the generator alone decides
