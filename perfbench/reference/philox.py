"""Counter-based Philox-4x32-10 normals keyed on (seed, step): the law of
the z noise of the CVAE's train step, frozen here so that the reference
draws the same eps as the program without importing it.

Element (n, s, l) of a draw (row n, sample s, latent column l) is word
l % 4 of the Philox block with counter (l // 4, s, n, 0) under the key
(seed, step); a word becomes a normal as a 23-bit uniform clipped to
[1e-7, 1 - 1e-7], then sqrt(2) * erfinv(2u - 1).
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROOT2 = 1.4142135623730951


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m for int64 a < 2^32, m split in
    16-bit halves so that no partial product overflows int64."""
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    mid = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (mid >> 32), mid & MASK32


def philox4x32(counter, seed: int, step: int):
    c0, c1, c2, c3 = counter
    k0, k1 = seed & MASK32, step & MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normals(seed: int, step: int, n_rows: int, n_samples: int, latent: int,
            device) -> torch.Tensor:
    """eps [n_rows, n_samples, latent] f32 of key (seed, step)."""
    groups = -(-latent // 4)
    i64 = dict(dtype=torch.int64, device=device)
    shape = (n_rows, n_samples, groups)
    q = torch.arange(groups, **i64).view(1, 1, groups).expand(shape)
    s = torch.arange(n_samples, **i64).view(1, n_samples, 1).expand(shape)
    n = torch.arange(n_rows, **i64).view(n_rows, 1, 1).expand(shape)
    words = philox4x32((q, s, n, torch.zeros(shape, **i64)), seed, step)
    bits = torch.stack(words, dim=-1).reshape(n_rows, n_samples, 4 * groups)
    u = (bits[..., :latent] >> 9).to(torch.float32) / 8388608.0
    u = u.clamp(1e-7, 1.0 - 1e-7)
    return ROOT2 * torch.special.erfinv(2.0 * u - 1.0)
