"""The train path's data-parallel hooks (counterpart of the train half of
``vae_captioning_tpu/parallel/kernel_shard.py``).

The JAX package wraps each train kernel in ``shard_map`` over the ``dp``
axis.  Here each rank runs the kernels on its own rows as they are: the
LSTM sequence, the fused z and the AG heads are independent across rows,
and their weight gradients are partial sums that the gradient all-reduce
completes.  What the step over ranks must change is where a row's value
depends on the whole batch:

* the means of the loss: the masked CE is divided by the global batch's
  token count (the JAX ``linear_ce``'s psummed ``total``, and the plain
  CE's global mean under pjit), and the KL's masked mean by its row
  count, under every CE schedule (``counts``: every rank holds the whole
  host batch, so the counts need no collective).  Each rank's loss is
  then its share of the global loss, and the sum of the ranks' gradients
  (``mesh.all_reduce_sum_``) is the global loss's gradient, before the
  global-norm clip, as under pjit;
* the noise: ``fused_z`` folds the rank into its seed with the JAX
  formula, ``seed ^ ((rank + 1) * 0x9E3779B9 mod 2^32)``, so ranks draw
  distinct noise, and the device generators (dropout, the GMM cluster
  draws) are seeded per rank (``seed``).  On one rank nothing is folded.

The decode half (``generate_captions`` over ranks) is ROADMAP A.9 rest.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vae_captioning_torch.parallel import mesh

GOLDEN = 0x9E3779B9
MASK32 = 0xFFFFFFFF


def fold_seed(seed: int, rank: int) -> int:
    """``seed`` with ``rank`` folded in as the JAX ``kernel_shard`` folds a
    shard's ``axis_index``: seed ^ ((rank + 1) · 0x9E3779B9 mod 2^32)."""
    return (seed ^ ((rank + 1) * GOLDEN)) & MASK32


class DataParallel:
    """This process's hooks in a train step over ``world`` ranks (one
    rank: every hook is the identity, and the step is the one-card
    step)."""

    def __init__(self, rank: int = 0, world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} out of range for {world} ranks")
        self.rank, self.world = rank, world

    @classmethod
    def current(cls) -> "DataParallel":
        """The hooks of this process's group (one rank without one)."""
        return cls(*mesh.process_info())

    def seed(self, seed: int) -> int:
        """A seed of this rank's noise: ``seed`` on one rank, else
        :func:`fold_seed`."""
        return seed if self.world == 1 else fold_seed(seed, self.rank)

    def counts(self, labels: np.ndarray) -> Optional[Tuple[float, float]]:
        """The divisors of the loss's means for the global host batch's
        ``labels`` [..., T]: None on one rank (each mean counts its own
        batch), else :func:`batch_counts`."""
        return None if self.world == 1 else batch_counts(labels)


def batch_counts(labels: np.ndarray) -> Tuple[float, float]:
    """(tokens, rows) of a host batch's labels [..., T]: the labels that
    are not PAD (0), the CE's divisor, and the caption rows holding one,
    the KL's; the padding rows a rank's share adds hold none."""
    mask = np.asarray(labels).reshape(-1, np.shape(labels)[-1]) != 0
    return float(mask.sum()), float(mask.any(axis=1).sum())


SINGLE = DataParallel()
