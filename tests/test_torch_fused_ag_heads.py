"""The AG heads of the port (ops/fused_ag_heads.py) against the JAX
package's: ``ag_heads_plain`` and the wrapper's CPU branch against
``ag_heads_xla`` (forward and the four gradients), and against the Pallas
``fused_ag_heads`` in interpret mode, at the four geometries of
tests/test_fused_ag_heads.py: one group, two groups with the last one
padded (K = 12), row tiling with a ragged last tile, and L = 37.  The
port's W is the ``nn.Linear`` weight, the Flax kernel transposed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vae_captioning_tpu.ops.fused_ag_heads as jfah
from vae_captioning_torch.ops import fused_ag_heads as tfah

GEOMETRIES = [
    dict(B=48, H=64, K=7, L=150),    # one group, one row tile
    dict(B=48, H=64, K=12, L=150),   # two groups, the last one padded
    dict(B=520, H=64, K=7, L=150),   # row tiles with B % 256 != 0
    dict(B=32, H=64, K=5, L=37),     # odd latent width
]
# the JAX kernel rounds each c_v-weighted product to bf16 before its
# cluster fold and rounds dq to bf16 (tests/test_fused_ag_heads.py)
KERNEL_REL = 6e-3
# the same maths and rounding points as ag_heads_xla, f32 sums in another
# order: forward and db to FWD_REL of the largest element; dh, dW and dc_v
# come back rounded to bf16 on both sides, so an element whose f32 sums
# straddle a bf16 rounding boundary is one bf16 step apart, plus the f32
# sum-order error (FWD_REL of the largest element) where terms cancel
FWD_REL = 1e-5


def _bf16_step(x):
    """The spacing of bf16 values at |x| (7 explicit mantissa bits)."""
    with np.errstate(divide="ignore"):
        return np.exp2(np.floor(np.log2(np.abs(x))) - 7)


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfah.pl, "pallas_call", patched)


def _problem(B, H, K, L, seed=0, zero_row=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, H)).astype(np.float32)
    w = rng.normal(0, 0.05, size=(H, 2 * K * L)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(2 * K * L,)).astype(np.float32)
    cv = rng.random((B, K)).astype(np.float32)
    if zero_row:
        cv[1] = 0.0                               # an image with no detection
    cv = cv / np.maximum(cv.sum(-1, keepdims=True), 1e-9)
    return h, w, b, cv


def _loss_jax(fn, h, w, b, cv):
    m, s = fn(h, w, b, cv)
    return jnp.sum(m ** 2) + jnp.sum(jnp.log(s + 1e-6) ** 2)


def _jax_side(fn, h, w, b, cv):
    args = [jnp.asarray(a) for a in (h, w, b, cv)]
    m, s = fn(*args)
    grads = jax.grad(lambda *a: _loss_jax(fn, *a), argnums=(0, 1, 2, 3))(*args)
    dh, dw, db, dcv = (np.asarray(g) for g in grads)
    return np.asarray(m), np.asarray(s), (dh, dw.T, db, dcv)


def _torch_side(fn, h, w, b, cv):
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (h, np.ascontiguousarray(w.T), b, cv)]
    m, s = fn(*leaves)
    (m.square().sum() + torch.log(s + 1e-6).square().sum()).backward()
    return (m.detach().numpy(), s.detach().numpy(),
            tuple(t.grad.numpy() for t in leaves))


def _rel(a, e):
    return float(np.abs(a - e).max() / (np.abs(e).max() + 1e-30))


@pytest.mark.parametrize("fn", [tfah.ag_heads_plain, tfah.fused_ag_heads],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("dims", GEOMETRIES, ids=lambda d: "-".join(
    f"{k}{v}" for k, v in d.items()))
def test_plain_matches_ag_heads_xla(fn, dims):
    args = _problem(**dims)
    jm, js, jg = _jax_side(jfah.ag_heads_xla, *args)
    tm, ts, tg = _torch_side(fn, *args)
    assert tm.shape == ts.shape == (dims["B"], dims["L"])
    assert tm.dtype == ts.dtype == np.float32
    assert _rel(tm, jm) <= FWD_REL and _rel(ts, js) <= FWD_REL
    for name, a, e in zip(["dh", "dw", "db", "dcv"], tg, jg):
        assert a.shape == e.shape, name
        if name == "db":
            assert _rel(a, e) <= FWD_REL, name
        else:
            step = _bf16_step(np.maximum(np.abs(a), np.abs(e)))
            assert np.all(np.abs(a - e) <= step + FWD_REL * np.abs(e).max()), name
    assert np.all(tm[1] == 0.0) and np.all(ts[1] == 0.0)    # c_v row of zeros


@pytest.mark.parametrize("dims", GEOMETRIES, ids=lambda d: "-".join(
    f"{k}{v}" for k, v in d.items()))
def test_wrapper_matches_the_pallas_kernel(interpreted, dims):
    args = _problem(**dims, seed=0, zero_row=False)   # the JAX test's inputs
    jm, js, jg = _jax_side(jfah.fused_ag_heads, *args)
    tm, ts, tg = _torch_side(tfah.fused_ag_heads, *args)
    assert _rel(tm, jm) <= KERNEL_REL and _rel(ts, js) <= KERNEL_REL
    for name, a, e in zip(["dh", "dw", "db", "dcv"], tg, jg):
        assert _rel(a, e) <= KERNEL_REL, name


@pytest.mark.parametrize("K,L", [(90, 150), (12, 150), (7, 150), (5, 37),
                                 (200, 3)])
def test_group_geometry_matches_the_tpu_kernel(interpreted, K, L):
    """At the TPU kernel's cluster groupings (``_group_geometry``: kb
    clusters a group, the last group padded to G·kb clusters; at (200, 3)
    all 200 in one group, at (90, 150) 12 groups of 8, 6 of the last
    group's clusters padding) the
    port computes what the Pallas kernel computes, forward and the four
    gradients, though its own kernels group clusters another way
    (``ag_fwd_plan``, ``ag_bwd_plan``: test_backward_plan_* at these
    (K, L))."""
    kb, G, Kp = jfah._group_geometry(K, L)
    assert G * kb == Kp and (G - 1) * kb < K <= Kp
    args = _problem(B=8, H=64, K=K, L=L, seed=K, zero_row=False)
    jm, js, jg = _jax_side(jfah.fused_ag_heads, *args)
    tm, ts, tg = _torch_side(tfah.fused_ag_heads, *args)
    assert _rel(tm, jm) <= KERNEL_REL and _rel(ts, js) <= KERNEL_REL
    for name, a, e in zip(["dh", "dw", "db", "dcv"], tg, jg):
        assert _rel(a, e) <= KERNEL_REL, name


def test_backward_plain_matches_autograd():
    """ag_heads_bwd_plain, the yardstick of the backward kernel, is the
    gradient of ag_heads_plain for given output cotangents."""
    h, w, b, cv = (torch.from_numpy(a) for a in _problem(B=20, H=64, K=5, L=37))
    w = w.t().contiguous()
    g = torch.Generator().manual_seed(0)
    gm, gs = torch.randn((20, 37), generator=g), torch.randn((20, 37), generator=g)
    leaves = [t.clone().requires_grad_() for t in (h, w, b, cv)]
    m, s = tfah.ag_heads_plain(*leaves)
    ((m * gm).sum() + (s * gs).sum()).backward()
    for got, leaf in zip(tfah.ag_heads_bwd_plain(h, w, b, cv, gm, gs), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=0)


@pytest.mark.parametrize("shapes,match", [
    (((8, 96), (2 * 5 * 37, 96), (2 * 5 * 37,), (8, 5)), "multiple of 64"),
    (((8, 64), (2 * 5 * 37, 64), (2 * 5 * 37,), (7, 5)), "disagree"),
    (((8, 64), (2 * 5 * 37 + 1, 64), (2 * 5 * 37 + 1,), (8, 5)), "disagree"),
    (((0, 64), (2 * 5 * 37, 64), (2 * 5 * 37,), (0, 5)), "no rows"),
    (((8, 64, 1), (2 * 5 * 37, 64), (2 * 5 * 37,), (8, 5)), r"h \[N, H\]"),
])
def test_kernel_shape_rules(shapes, match):
    """The checks a CUDA tensor meets before the kernels launch."""
    with pytest.raises(ValueError, match=match):
        tfah._check(*(torch.zeros(s) for s in shapes))


# (N, K, L): the train shapes, the card checks' ragged ones, one row, one
# row past a tile, fewer clusters than a group, a latent size above one
# tile's columns
FWD_PLAN_DIMS = [(1280, 90, 150), (1000, 12, 150), (1000, 7, 37),
                 (1, 90, 150), (65, 90, 150), (70, 7, 37), (3, 1, 5),
                 (200, 3, 300)]


@pytest.mark.parametrize("N,K,L", FWD_PLAN_DIMS)
def test_forward_plan_covers_each_block_once(N, K, L):
    """The forward's blocks meet every (row tile, latent column, cluster)
    exactly once under the kernel's rule: block (x, y, z) takes rows
    [128x, 128x + 128), latent columns [cols·y, cols·y + cols) below L and
    clusters [kb·z, min(K, kb·z + kb)); no group is empty."""
    plan = tfah.ag_fwd_plan(N, K, L)
    assert plan.cols in (40, 80) and 1 <= plan.kb <= K
    m_tiles = -(-N // 128)
    assert plan.grid == (m_tiles, -(-L // plan.cols), -(-K // plan.kb))
    seen = {}
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            for z in range(plan.grid[2]):
                ks = range(z * plan.kb, min(K, (z + 1) * plan.kb))
                assert len(ks) > 0
                for l in range(y * plan.cols, min(L, (y + 1) * plan.cols)):
                    for k in ks:
                        seen[x, l, k] = seen.get((x, l, k), 0) + 1
    assert seen == {(x, l, k): 1 for x in range(m_tiles) for l in range(L)
                    for k in range(K)}


@pytest.mark.parametrize("N,K,L", FWD_PLAN_DIMS)
def test_forward_plan_workspace_within_bound(N, K, L):
    """The groups' [2, N, L] f32 partials stay within the stated 64 MiB
    (one group may exceed it alone), and at the train shapes the plan is
    two latent tiles of 80 columns and 13 groups of 7 clusters: 260
    blocks, 98% of 2 waves on 132 SMs."""
    plan = tfah.ag_fwd_plan(N, K, L)
    assert plan.part == (plan.groups, 2, N, L)
    assert plan.groups == 1 or plan.groups * 2 * N * L * 4 <= 64 << 20
    if (N, K, L) == (1280, 90, 150):
        assert (plan.cols, plan.kb) == (80, 7)
        assert plan.grid == (10, 2, 13)


# (N, H, K, L): the train shapes, one row, one row past a 64-row and a
# 128-row tile, the widths past the resident h (768, 1024) and below (64),
# odd L, fewer clusters than a group, and the TPU kernel's groupings of
# test_group_geometry_matches_the_tpu_kernel
BWD_PLAN_DIMS = [(1280, 512, 90, 150), (1, 512, 90, 150), (65, 512, 90, 150),
                 (129, 512, 90, 150), (1000, 64, 12, 150), (300, 768, 12, 150),
                 (300, 1024, 7, 37), (70, 128, 7, 37), (3, 64, 1, 5),
                 (130, 256, 7, 150), (70, 64, 5, 37), (65, 64, 200, 3)]


def _cover(n: int, tile: int, tiles: int) -> np.ndarray:
    """How often each of [0, n) falls in tiles [tile·t, tile·t + tile), t
    < tiles."""
    count = np.zeros(n, np.int64)
    for t in range(tiles):
        count[t * tile:(t + 1) * tile] += 1
    return count


@pytest.mark.parametrize("N,H,K,L", BWD_PLAN_DIMS)
def test_backward_plan_covers_each_element_once(N, H, K, L):
    """Under the kernels' rules each grid is a product of ranges, so each
    axis is covered on its own: the dq pass's blocks meet every row,
    latent column and cluster once (no empty cluster group), each row
    falls in one warp's db partial and each latent column in one dc_v
    partial; dW's blocks meet every row of dW and column of H once, and
    dh's every row, column and 64-column contraction tile once (no empty
    split)."""
    plan = tfah.ag_bwd_plan(N, H, K, L)
    C2 = 2 * K * L
    c_tiles = -(-C2 // 64)
    mt, lt, gz = plan.dq_grid
    assert np.all(_cover(N, 128, mt) == 1)
    assert np.all(_cover(L, plan.cols, lt) == 1)
    assert np.all(_cover(K, plan.kb, gz) == 1) and (gz - 1) * plan.kb < K
    assert np.all(_cover(N, 16, plan.db_part[0]) == 1)
    assert plan.dcv_part == (lt, N, K) and plan.db_part[1] == C2
    assert H % plan.ct == 0 and plan.ct in (64, 128, 256, 512)
    assert plan.dw_grid == (c_tiles, H // plan.ct, 1)
    assert np.all(_cover(C2, 64, plan.dw_grid[0]) == 1)
    assert np.all(_cover(H, plan.ct, plan.dw_grid[1]) == 1)
    xt, ct, splits = plan.dh_grid
    assert np.all(_cover(N, 64, xt) == 1) and ct == H // plan.ct
    assert np.all(_cover(c_tiles, plan.per, splits) == 1)
    assert (splits - 1) * plan.per < c_tiles


@pytest.mark.parametrize("N,H,K,L", BWD_PLAN_DIMS)
def test_backward_plan_workspaces_within_bound(N, H, K, L):
    """dh's [S, Np, H] f32 partials (Np: N in whole 64-row tiles) stay
    within the stated 64 MiB (one split may exceed it alone); db's per-warp partials are one per 16
    rows, at most a 128-row tile past N (an eighth of dq's bf16 bytes,
    plus that tile); and at the train shapes the plan is 40 latent
    columns, 7 clusters a block, column tile 512 and 6 dh splits."""
    plan = tfah.ag_bwd_plan(N, H, K, L)
    Np = 64 * -(-N // 64)
    assert plan.dh_part == (plan.splits, Np, H)
    assert plan.splits == 1 or plan.splits * Np * H * 4 <= 64 << 20
    assert N <= 16 * plan.db_part[0] < N + 128
    if (N, H, K, L) == (1280, 512, 90, 150):
        assert (plan.cols, plan.kb, plan.ct, plan.per) == (40, 7, 512, 71)
        assert plan.dq_grid == (10, 4, 13) and plan.dh_grid == (20, 1, 6)
