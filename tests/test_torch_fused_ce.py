"""The flash linear CE of the port (ops/fused_ce.py) against the JAX
package's: ``fused_linear_ce_plain`` and the wrapper's CPU branch against
the Pallas ``fused_linear_ce`` in interpret mode (forward, and the
gradients of h, w, b and the row weights through its custom VJP) and the
forward against ``fused_linear_ce_xla``; ``linear_ce`` against
``kernel_shard.linear_ce`` on one device over time-major hidden rows;
zero-weight rows; the plain yardsticks of the three kernels; and the
checks a CUDA tensor meets before the kernels launch.  The port's W is
the ``nn.Linear`` weight [V, H], the Flax kernel transposed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import fused_ce as jfc
from vae_captioning_tpu.parallel import kernel_shard as jks
from vae_captioning_torch.ops import fused_ce as tfc

FNS = [tfc.fused_linear_ce_plain, tfc.fused_linear_ce]
IDS = ["plain", "wrapper"]
# the forward: the same f32 logits from bf16 operands, summed in another
# order, so the loss and d weights (= lse - ll) to FWD_REL
FWD_REL = 1e-5
# dh and dW: both sides round dl to bf16 before the products; an element
# of dl whose f32 value the two sum orders put on either side of a bf16
# rounding boundary moves its product by one bf16 step of dl times W,
# below GRAD_REL of the largest element (9e-6 measured).  db is summed
# from the f32 dl on both sides: FWD_REL
GRAD_REL = 1e-4


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfc.pl, "pallas_call", patched)


def _problem(M=300, H=64, V=2000, seed=0):
    """tests/test_fused_ce.py's problem with a ragged mask: about a fifth
    of the rows weigh 0, and the first five are among them."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(M, H)).astype(np.float32)
    w = rng.normal(0, 0.1, size=(H, V)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    labels = rng.integers(0, V, M).astype(np.int32)
    mask = (rng.random(M) > 0.2).astype(np.float32)
    mask[:5] = 0.0
    return h, w, b, labels, (mask / mask.sum()).astype(np.float32)


def _rel(a, e):
    a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
    return float(np.abs(a - e).max() / (np.abs(e).max() + 1e-30))


def _jax_side(fn, h, w, b, labels, weights):
    args = [jnp.asarray(a) for a in (h, w, b, labels, weights)]
    loss, grads = jax.value_and_grad(fn, argnums=(0, 1, 2, 4))(*args)
    dh, dw, db, dwt = (np.asarray(g) for g in grads)
    return float(loss), (dh, dw.T, db, dwt)


def _torch_side(fn, h, w, b, labels, weights):
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
              for a in (h, w.T, b)]
    wt = torch.from_numpy(weights).requires_grad_()
    loss = fn(*leaves, torch.from_numpy(labels), wt)
    loss.backward()
    return float(loss.detach()), tuple(t.grad.numpy() for t in (*leaves, wt))


@pytest.mark.parametrize("fn", FNS, ids=IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_the_pallas_kernel(interpreted, fn, seed):
    args = _problem(seed=seed)
    j_loss, jg = _jax_side(jfc.fused_linear_ce, *args)
    t_loss, tg = _torch_side(fn, *args)
    assert t_loss == pytest.approx(j_loss, rel=FWD_REL)
    assert t_loss == pytest.approx(
        float(jfc.fused_linear_ce_xla(*(jnp.asarray(a) for a in args))),
        rel=FWD_REL)
    for name, a, e, tol in zip(("dh", "dw", "db", "dweights"), tg, jg,
                               (GRAD_REL, GRAD_REL, FWD_REL, FWD_REL)):
        assert a.shape == e.shape and a.dtype == np.float32, name
        assert _rel(a, e) <= tol, (name, _rel(a, e))
    # rows of weight 0 get no gradient, exactly, on both sides
    zero = args[4] == 0
    assert np.all(tg[0][zero] == 0.0) and np.all(jg[0][zero] == 0.0)
    assert np.abs(tg[0][~zero]).max() > 0


# past the widths built at compile time: the JAX kernels take any H (they
# pad only M and V), the port's every multiple of 64 up to 4096 (576 as it
# is, 1000 padded to 1024 by pad_ce); the three schedules' plain twins and
# their padded calls against the Pallas functions, at the tolerances above
# (the written-logits schedules' own, tests/test_torch_fused_ce_mat.py,
# are the same numbers)
WIDE_H = [576, 1000]
WIDE_SCHEDULES = {
    "flash": (jfc.fused_linear_ce, tfc.fused_linear_ce_plain),
    "hybrid": (jfc.fused_linear_ce_hybrid, tfc.fused_linear_ce_hybrid_plain),
    "xla_bwd": (jfc.fused_linear_ce_xla_bwd, tfc.fused_linear_ce_xla_bwd_plain),
}


@pytest.mark.parametrize("schedule", list(WIDE_SCHEDULES))
@pytest.mark.parametrize("H", WIDE_H)
def test_matches_the_pallas_kernels_past_512(interpreted, schedule, H):
    """The loss, dh, dW, db and d weights of each schedule at M = 70, V =
    300 and H past 512, the port's plain twin on the unpadded operands and
    on the operands padded to ``ce_width(H)`` (whose gradients autograd
    slices back) against the JAX function."""
    args = _problem(M=70, H=H, V=300, seed=H)
    jfn, tfn = WIDE_SCHEDULES[schedule]
    j_loss, jg = _jax_side(jfn, *args)
    assert tfc.ce_width(H) == {576: 576, 1000: 1024}[H]

    def padded(h, w, b, labels, weights):
        return tfn(*tfc.pad_ce(h, w), b, labels, weights)

    for fn in (tfn, padded):
        t_loss, tg = _torch_side(fn, *args)
        assert t_loss == pytest.approx(j_loss, rel=FWD_REL)
        for name, a, e, tol in zip(("dh", "dw", "db", "dweights"), tg, jg,
                                   (GRAD_REL, GRAD_REL, FWD_REL, FWD_REL)):
            assert a.shape == e.shape and a.dtype == np.float32, name
            assert _rel(a, e) <= tol, (name, _rel(a, e))
        zero = args[4] == 0
        assert np.all(tg[0][zero] == 0.0)


@pytest.mark.parametrize("fn", FNS, ids=IDS)
def test_linear_ce_matches_kernel_shard(interpreted, fn):
    """Time-major hidden rows [T, N, H] and labels [T, N] with PAD (0)
    rows, flattened and weighted as the JAX package's single-device
    ``linear_ce`` does."""
    rng = np.random.default_rng(5)
    T, N, H, V = 6, 9, 64, 300
    hidden = rng.normal(size=(T, N, H)).astype(np.float32)
    w = rng.normal(0, 0.1, size=(H, V)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(V,)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=N)
    labels = rng.integers(1, V, size=(T, N)).astype(np.int32)
    labels[np.arange(T)[:, None] >= lengths[None, :]] = 0
    j_args = [jnp.asarray(a) for a in (hidden, w, b)]
    j_loss, (j_dh, j_dw) = jax.value_and_grad(
        lambda hd, ww, bb: jks.linear_ce(jfc.fused_linear_ce, hd, ww, bb,
                                         jnp.asarray(labels), batch_axis=1),
        argnums=(0, 1))(*j_args)
    t_hidden = torch.from_numpy(hidden).requires_grad_()
    t_w = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    t_loss = tfc.linear_ce(t_hidden, t_w, torch.from_numpy(b),
                           torch.from_numpy(labels), ce_fn=fn)
    t_loss.backward()
    assert float(t_loss.detach()) == pytest.approx(float(j_loss), rel=FWD_REL)
    assert _rel(t_hidden.grad.numpy(), j_dh) <= GRAD_REL
    assert _rel(t_w.grad.numpy(), np.asarray(j_dw).T) <= GRAD_REL
    assert np.all(t_hidden.grad.numpy()[labels == 0] == 0.0)


def test_rows_of_weight_zero_may_carry_any_label():
    """Labels past the vocabulary on rows of weight 0 pick nothing and
    add nothing: the loss and every gradient equal those of label 0."""
    h, w, b, labels, weights = _problem(M=40, V=100, seed=3)
    outs = []
    for bad in (0, -1, 100, 12345):
        lab = labels.copy()
        lab[weights == 0] = bad
        outs.append(_torch_side(tfc.fused_linear_ce_plain, h, w, b, lab, weights))
    for loss, grads in outs[1:]:
        assert loss == outs[0][0]
        for a, e in zip(grads[:3], outs[0][1][:3]):
            np.testing.assert_array_equal(a, e)


def test_plain_backward_is_the_kernels_function():
    """``ce_dh_plain`` and ``ce_dwdb_plain``, the yardsticks of the dh and
    dW/db kernels, give the plain VJP's gradients exactly;
    ``ce_fwd_plain`` gives its lse and label logit."""
    h, w, b, labels, weights = (torch.from_numpy(np.ascontiguousarray(a))
                                for a in _problem(M=50, V=300, seed=4))
    w = w.t().contiguous()
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    tfc.fused_linear_ce_plain(*leaves, labels, weights).backward()
    lse, ll = tfc.ce_fwd_plain(h, w, b, labels)
    S = h.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t() + b
    torch.testing.assert_close(lse, torch.logsumexp(S, 1), rtol=0, atol=0)
    torch.testing.assert_close(ll, S[torch.arange(50), labels.long()],
                               rtol=0, atol=0)
    dh = tfc.ce_dh_plain(h, w, b, labels, lse, weights)
    dw, db = tfc.ce_dwdb_plain(h, w, b, labels, lse, weights)
    for got, leaf in zip((dh, dw, db), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=0)


def test_weights_need_no_gradient():
    h, w, b, labels, weights = _problem(M=20, V=50, seed=6)
    t_h = torch.from_numpy(h).requires_grad_()
    loss = tfc.fused_linear_ce(t_h, torch.from_numpy(np.ascontiguousarray(w.T)),
                               torch.from_numpy(b), torch.from_numpy(labels),
                               torch.from_numpy(weights))
    loss.backward()
    assert t_h.grad.shape == (20, 64) and bool(torch.isfinite(t_h.grad).all())


@pytest.mark.parametrize("shapes,match", [
    (((8, 96), (50, 96), (50,), (8,)), "one of"),
    (((8, 64), (50, 64), (49,), (8,)), "disagree"),
    (((8, 64), (50, 32), (50,), (8,)), "disagree"),
    (((8, 64), (50, 64), (50,), (7,)), "disagree"),
    (((0, 64), (50, 64), (50,), (0,)), "no rows"),
])
def test_kernel_shape_rules(shapes, match):
    """The checks a CUDA tensor meets before the kernels launch."""
    with pytest.raises(ValueError, match=match):
        tfc._check(*(torch.zeros(s) for s in shapes))


# (M, H, V): the train shapes, the card tests' ragged ones, one row, one
# row past a tile, a vocabulary smaller than a tile, a small vocabulary
# under many rows
PLAN_SHAPES = [(30720, 512, 11500), (1000, 512, 11519), (300, 64, 2000),
               (77, 128, 301), (1, 512, 11500), (65, 256, 11500),
               (100, 64, 37), (30720, 512, 300)]


def _covered(grid, k_tiles, per):
    """{(output tile, streamed tile): times covered} under the backward
    kernels' rule: block (x, y) owns tile x and streams tiles [y·per,
    min(k_tiles, (y + 1)·per))."""
    seen = {}
    for x in range(grid[0]):
        for y in range(grid[1]):
            for k in range(y * per, min(k_tiles, (y + 1) * per)):
                seen[x, k] = seen.get((x, k), 0) + 1
    return seen


# the two schedules whose backward kernels take ce_bwd_plan's launches:
# the flash CE (a (row tile, vocab tile) pair is one logits tile
# recomputed) and the written logits (hybrid and XLA forward: the pair is
# the 64 x 64 box of lg that the block reads and turns into dl)
BWD_USES = ["flash", "written_logits"]


@pytest.mark.parametrize("use", BWD_USES)
@pytest.mark.parametrize("M,H,V", PLAN_SHAPES)
def test_backward_plan_covers_each_tile_pair_once(M, H, V, use):
    """Both backward kernels of either schedule meet every (row tile,
    vocab tile) pair exactly once (the written logits: read every box of
    lg once), and no dW/db split is empty."""
    plan = tfc.ce_bwd_plan(M, H, V)
    m_tiles, v_tiles = -(-M // 64), -(-V // 64)
    if use == "written_logits":
        # lg [M, Vp] in 64 x 64 boxes: Vp = 64·v_tiles columns
        assert tfc.logits_pitch(V) == v_tiles * 64
    want = {(m, v): 1 for m in range(m_tiles) for v in range(v_tiles)}
    dh = _covered(plan.dh_grid, plan.dh_k_tiles, plan.dh_k_tiles)
    assert dh == want
    dwdb = _covered(plan.dwdb_grid, plan.dwdb_k_tiles, plan.dwdb_per)
    assert {(m, v): n for (v, m), n in dwdb.items()} == want
    assert all(y * plan.dwdb_per < m_tiles for y in range(plan.splits))
    assert plan.dh_rows >= M and plan.dh_rows % 64 == 0
    assert plan.dw_part == (plan.splits, v_tiles * 64, H)
    assert plan.db_part == (plan.splits, v_tiles * 64)


@pytest.mark.parametrize("use", BWD_USES)
@pytest.mark.parametrize("M,H,V", PLAN_SHAPES)
def test_backward_plan_workspace_within_bound(M, H, V, use):
    """The dW/db partials of either schedule stay within the stated 128
    MiB (one split may exceed it alone), and at the train shapes the plan
    is 5 splits of 96 row tiles: 900 blocks fill 97% of 7 waves on 132
    SMs, against 91% for 4 splits."""
    plan = tfc.ce_bwd_plan(M, H, V)
    s, Vp, h = plan.dw_part
    assert s == 1 or s * Vp * h * 4 <= 128 << 20
    if (M, H, V) == (30720, 512, 11500):
        assert (plan.splits, plan.dwdb_per) == (5, 96)
        assert plan.dwdb_grid == (180, 5) and plan.dh_grid == (480, 1)
        assert s * Vp * h * 4 == 112.5 * 2**20
        assert tfc._wave_fill(900, 132) > 0.97 > tfc._wave_fill(720, 132)


# (M, V): the plan shapes' (M, V), a vocabulary smaller than a tile at one
# row
FWD_PLAN_SHAPES = sorted({(M, V) for M, _, V in PLAN_SHAPES} | {(1, 37)})


@pytest.mark.parametrize("use", BWD_USES)
@pytest.mark.parametrize("M,V", FWD_PLAN_SHAPES)
def test_forward_plan_covers_each_tile_pair_once(M, V, use):
    """The forward kernel of either schedule (the flash forward and the
    written-logits one are one template) meets every (128-row tile,
    128-column vocab tile) pair exactly once, and no vocab chunk is empty;
    the written logits' Vp columns all lie in those tiles."""
    plan = tfc.ce_fwd_plan(M, V)
    m_tiles, v_tiles = -(-M // 128), -(-V // 128)
    assert plan.grid[0] == m_tiles and plan.v_tiles == v_tiles
    seen = _covered(plan.grid, v_tiles, plan.chunk_tiles)
    assert seen == {(m, v): 1 for m in range(m_tiles) for v in range(v_tiles)}
    assert all(y * plan.chunk_tiles < v_tiles for y in range(plan.grid[1]))
    if use == "written_logits":
        assert V <= tfc.logits_pitch(V) <= 128 * v_tiles
        assert tfc.logits_pitch(V) % 64 == 0


@pytest.mark.parametrize("M,V", FWD_PLAN_SHAPES)
def test_forward_plan_workspace_within_bound(M, V):
    """The chunks' (m, s, ll) partials stay within the stated 16 MiB (one
    chunk may exceed it alone), and at the train shapes the plan is 6
    chunks of 15 vocab tiles: 1,440 blocks, 99% of 11 waves on 132 SMs."""
    plan = tfc.ce_fwd_plan(M, V)
    chunks = plan.grid[1]
    assert plan.part == (chunks, M, 3)
    assert chunks == 1 or chunks * M * 3 * 4 <= 16 << 20
    if (M, V) == (30720, 11500):
        assert plan.grid == (240, 6) and plan.chunk_tiles == 15


# ----------------------------------------------------------------------
# the plans past H = 512
# ----------------------------------------------------------------------

# the widths past 512 the planners are held at: the GMM parity width, the
# wide cell's, twice it and CE_H_MAX
WIDE_PLAN_H = [576, 1024, 2048, 4096]


@pytest.mark.parametrize("H", WIDE_PLAN_H + [640, 960, 1088, 1000])
def test_column_tiles_cover_the_width_once(H):
    """The backward kernels' output column tiles (csrc/fused_ce.cu's and
    fused_ce_mat.cu's launches) cover ce_width(H)'s columns once, in
    order: tiles of 512 (m64n256 a warpgroup), then at most one each of
    256, 128 and 64."""
    Hp = tfc.ce_width(H)
    tiles = tfc.col_tiles(Hp)
    assert sum(tiles) == Hp and list(tiles) == sorted(tiles, reverse=True)
    assert set(tiles) <= {512, 256, 128, 64}
    assert all(tiles.count(ct) <= 1 for ct in (256, 128, 64))
    assert tiles == {576: (512, 64), 640: (512, 128), 960: (512, 256, 128, 64),
                     1024: (512, 512), 1088: (512, 512, 64), 2048: (512,) * 4,
                     4096: (512,) * 8}[Hp]


@pytest.mark.parametrize("H", [64, 128, 256, 512])
def test_column_tiles_at_the_fixed_widths(H):
    assert tfc.col_tiles(H) == (H,)


def test_widths_past_the_limit_raise():
    """Past CE_H_MAX the width, the tiles and the padding raise, naming
    the limit; 4096 itself is taken."""
    assert tfc.CE_H_MAX == 4096 and tfc.ce_width(4096) == 4096
    assert tfc.kernel_width(4096) and not tfc.kernel_width(4160)
    assert not tfc.kernel_width(600) and not tfc.kernel_width(192)
    for fn in (tfc.ce_width, tfc.col_tiles):
        with pytest.raises(ValueError, match="up to 4096"):
            fn(4160)
    with pytest.raises(ValueError, match="up to 4096"):
        tfc.pad_ce(torch.zeros((3, 4097)), torch.zeros((5, 4097)))


@pytest.mark.parametrize("use", BWD_USES)
@pytest.mark.parametrize("H", WIDE_PLAN_H)
@pytest.mark.parametrize("M,V", [(30720, 11500), (1000, 11519), (77, 301),
                                 (1, 11500)])
def test_backward_plan_past_512(M, H, V, use):
    """Past 512 both backward kernels of either schedule still meet every
    (row tile, vocab tile) pair once in each column tile, no dW/db split is
    empty, and the partials stay within 128 MiB unless one split alone
    exceeds it (H = 4096: 180 MiB at the train vocabulary).  At the train
    shapes at H = 1024: one split (two would fill the waves no better) of
    two column tiles, 360 blocks in 91% of 3 waves of 132 SMs."""
    plan = tfc.ce_bwd_plan(M, H, V)
    m_tiles, v_tiles = -(-M // 64), -(-V // 64)
    want = {(m, v): 1 for m in range(m_tiles) for v in range(v_tiles)}
    assert _covered(plan.dh_grid, plan.dh_k_tiles, plan.dh_k_tiles) == want
    dwdb = _covered(plan.dwdb_grid, plan.dwdb_k_tiles, plan.dwdb_per)
    assert {(m, v): n for (v, m), n in dwdb.items()} == want
    assert all(y * plan.dwdb_per < m_tiles for y in range(plan.splits))
    assert plan.col_tiles == tfc.col_tiles(H)
    assert plan.dw_part == (plan.splits, v_tiles * 64, H)
    s, Vp, h = plan.dw_part
    assert s == 1 or s * Vp * h * 4 <= 128 << 20
    if (M, H, V) == (30720, 1024, 11500):
        assert plan.splits == 1 and plan.col_tiles == (512, 512)
        assert plan.dwdb_grid == (180, 1) and plan.dh_grid == (480, 1)
        assert tfc._wave_fill(180 * 2, 132) > 0.9


# the forward's clusters along M: none, and the shape rule's two CTAs
FWD_CLUSTERS = [0, 2]


@pytest.mark.parametrize("cluster", FWD_CLUSTERS)
@pytest.mark.parametrize("use", BWD_USES)
@pytest.mark.parametrize("M,V", FWD_PLAN_SHAPES)
def test_forward_plan_on_64_row_blocks(M, V, use, cluster):
    """The forward's plan for the 64-row blocks that every width past 512
    takes (resident or streamed; the resident ones in clusters of 2 along
    M): every (64-row block, vocab tile) pair once, the blocks past M that
    round the row blocks up to whole clusters counted, no vocab chunk
    empty, two partials a chunk (one a warpgroup) within the 16 MiB of
    partials unless one chunk alone exceeds it; at the train shapes 3
    chunks of 30 vocab tiles, 1,440 blocks in 99% of 11 waves (in clusters
    of 2: 720 clusters in 99% of 11 waves of the 66 places)."""
    plan = tfc.ce_fwd_plan(M, V, rows=64, cluster=cluster)
    m_tiles, v_tiles = -(-M // 64), -(-V // 128)
    ctas = max(cluster, 1)
    assert plan.rows == 64 and plan.cluster == cluster
    assert plan.grid[0] == -(-m_tiles // ctas) * ctas
    seen = _covered(plan.grid, v_tiles, plan.chunk_tiles)
    assert seen == {(m, v): 1 for m in range(plan.grid[0]) for v in range(v_tiles)}
    assert all(y * plan.chunk_tiles < v_tiles for y in range(plan.grid[1]))
    chunks = plan.grid[1]
    assert plan.part == (2 * chunks, M, 3)
    assert chunks == 1 or 2 * chunks * M * 3 * 4 <= 16 << 20
    if (M, V) == (30720, 11500):
        assert plan.grid == (480, 3) and plan.chunk_tiles == 30
        assert tfc._wave_fill(480 * 3 // ctas, 132 // ctas) > 0.99


@pytest.mark.parametrize("cluster", FWD_CLUSTERS[1:])
@pytest.mark.parametrize("M,V", sorted(set(FWD_PLAN_SHAPES) | {(65, 11500), (100, 37),
                                                               (300, 11500)}))
def test_forward_cluster_divides_the_grid(M, V, cluster):
    """A cluster (at most the portable 8 CTAs) divides the forward's row
    blocks, which hold every 64-row block of h and, past M, fewer than a
    cluster of blocks with no row (in clusters of 2, M = 1 and 300 leave
    a cluster's second CTA none; 65, 77 and 100 a second CTA partly past
    M); the clusters of a chunk take every vocab tile of it, as the
    blocks alone do."""
    plan = tfc.ce_fwd_plan(M, V, rows=64, cluster=cluster)
    alone = tfc.ce_fwd_plan(M, V, rows=64)
    m_tiles = -(-M // 64)
    assert cluster <= 8 and plan.grid[0] % cluster == 0
    empty = plan.grid[0] - m_tiles
    assert 0 <= empty < cluster
    assert empty == (1 if M in (1, 300) else 0)
    assert plan.v_tiles == alone.v_tiles and plan.part[1:] == alone.part[1:]
    # a cluster's CTAs are adjacent row blocks of one chunk: x // cluster
    clusters = {(x // cluster, y) for x in range(plan.grid[0]) for y in range(plan.grid[1])}
    assert len(clusters) * cluster == plan.grid[0] * plan.grid[1]


@pytest.mark.parametrize("written_logits", [False, True])
@pytest.mark.parametrize("H", [64, 512, 520, 576, 640, 960, 1000, 1024, 1088, 1152,
                               1216, 1280, 1344, 2048, 4096])
def test_forward_cluster_shape_rule(H, written_logits):
    """The forward's shape rule past 512 (csrc/fused_ce.cuh's
    fwd_cluster): clusters of 2 where the 64-row blocks keep their rows
    resident (to 1280; with the written logits' staged boxes to 1152,
    fwd_block's widths), the fixed widths' 128-row blocks and the streamed
    blocks alone; the padded width decides (1000 -> 1024), and the wide
    cell's 1024 takes the cluster in both forwards."""
    Hp = tfc.ce_width(H)
    last = 1152 if written_logits else 1280
    want = 2 if 512 < Hp <= last else 0
    assert tfc.fwd_cluster(Hp, written_logits) == want
    if Hp == 1024:
        assert want == tfc.FWD_CLUSTER == 2
    plan = tfc.ce_fwd_plan(300, 2000, rows=64 if Hp > 512 else 128,
                           cluster=tfc.fwd_cluster(Hp, written_logits))
    assert plan.cluster == want


@pytest.mark.parametrize("M,V", [(30720, 11500), (30720, 300), (1000, 11519), (77, 301),
                                 (1, 11500), (65, 37)])
def test_forward_cluster_plan_workspace_within_bound(M, V):
    """In clusters the forward's (m, s, ll) partials, two a chunk, stay
    within the 16 MiB of partials (one chunk may exceed it alone), rows
    past M take none; the waves are counted in the places of clusters
    (132 SMs hold 66 of 2): at the train shapes 3 chunks, 720 clusters in
    11 waves, as the 1,440 blocks alone."""
    plan = tfc.ce_fwd_plan(M, V, rows=64, cluster=2)
    n, rows, three = plan.part
    assert rows == M and three == 3 and n == 2 * plan.grid[1]
    assert plan.grid[1] == 1 or n * M * 3 * 4 <= tfc._FWD_WORKSPACE
    if (M, V) == (30720, 11500):
        waves = -(-plan.grid[0] // 2 * plan.grid[1] // (132 // 2))
        assert plan.grid == (480, 3) and waves == 11


def test_forward_plan_takes_no_other_cluster():
    """The forward's plan takes clusters of 2 CTAs (the kernel's
    instances), or none."""
    for bad in (1, 3, 4, 8):
        with pytest.raises(ValueError, match="cluster"):
            tfc.ce_fwd_plan(300, 2000, rows=64, cluster=bad)


# ----------------------------------------------------------------------
# the flash backward's cluster at H = 1024
# ----------------------------------------------------------------------

def _column_cover(plan, H):
    """{(output tile, streamed tile, output column): times covered} by the
    dh launches: one grid a column tile of ``col_tiles``, or under a
    cluster one grid whose CTA (x, y, z) holds column tile z of Q tile x."""
    tiles = plan.col_tiles
    launches = ([(0, len(tiles))] if plan.cluster
                else [(z, 1) for z in range(len(tiles))])
    grid = plan.launch_grid(plan.dh_grid)[:2] if plan.cluster else plan.dh_grid
    seen = {}
    for first, ctas in launches:
        for (x, k), n in _covered(grid, plan.dh_k_tiles, plan.dh_k_tiles).items():
            for z in range(first, first + ctas):
                e0 = sum(tiles[:z])
                for col in range(e0, e0 + tiles[z], 64):
                    seen[x, k, col] = seen.get((x, k, col), 0) + n
    return seen


@pytest.mark.parametrize("H", [512, 576, 1000, 1024, 1088, 2048])
@pytest.mark.parametrize("M,V", [(1000, 11519), (77, 301), (1, 11500), (65, 37)])
def test_backward_covers_each_tile_and_column_once(M, V, H):
    """Each (Q tile, K tile, 64-column block of the output) is met by
    exactly one CTA that stores it: by a cluster's CTA at 1024, by one
    launch of a column tile elsewhere."""
    Hp = tfc.ce_width(H)
    plan = tfc.ce_bwd_plan(M, Hp, V)
    want = {(m, v, col): 1 for m in range(-(-M // 64)) for v in range(-(-V // 64))
            for col in range(0, Hp, 64)}
    assert _column_cover(plan, Hp) == want


@pytest.mark.parametrize("H", [1000, 1024])
@pytest.mark.parametrize("M,V", [(30720, 11500), (1000, 11519), (77, 301), (1, 11500)])
def test_cluster_divides_the_grid(M, V, H):
    """At 1024 the cluster, one Q tile x 2 column halves (2 CTAs, at most
    the portable 8), divides both launch grids, which hold every Q tile of
    the plan; its column halves are the column tiles, 512 each, and make
    up H."""
    plan = tfc.ce_bwd_plan(M, tfc.ce_width(H), V)
    assert plan.cluster == 2 <= 8 and tfc.BWD_CLUSTER == (1, 1, 2)
    for grid in (plan.dh_grid, plan.dwdb_grid):
        launch = plan.launch_grid(grid)
        assert all(g % c == 0 for g, c in zip(launch, tfc.BWD_CLUSTER))
        assert launch[:2] == grid
        assert launch[2] == len(plan.col_tiles)
    assert plan.col_tiles == (512, 512) and sum(plan.col_tiles) == tfc.BWD_CLUSTER_H


@pytest.mark.parametrize("H,cluster", [(64, 0), (512, 0), (520, 0), (576, 0),
                                       (960, 0), (1000, 2), (1024, 2), (1088, 0),
                                       (1536, 0), (2048, 0), (4096, 0)])
def test_cluster_shape_rule(H, cluster):
    """The shape rule: the cluster kernel takes the padded width 1024
    alone (1000 pads to it); the fixed widths take ce_bwd_kernel, the
    other widths past 512 the column tiles' ce_bwd_wide_kernel, by the
    rule and not by a retry."""
    Hp = tfc.ce_width(H)
    assert tfc.bwd_cluster(Hp) == cluster
    assert tfc.ce_bwd_plan(300, Hp, 2000).cluster == cluster


@pytest.mark.parametrize("M,V", [(30720, 11500), (30720, 300), (1000, 11519),
                                 (77, 301), (1, 11500)])
def test_cluster_plan_workspace_within_bound(M, V):
    """Under the cluster the dW/db partials stay within the 128 MiB of
    partials (one split may exceed it alone), no split is empty, and the
    wave fill is counted in clusters: at the train shapes one split of
    180 clusters, 91% of 3 waves of the 66 clusters of 2 that 132 SMs
    hold."""
    plan = tfc.ce_bwd_plan(M, 1024, V)
    s, Vp, h = plan.dw_part
    assert h == 1024 and (s == 1 or s * Vp * h * 4 <= 128 << 20)
    m_tiles = -(-M // 64)
    assert all(y * plan.dwdb_per < m_tiles for y in range(plan.splits))
    if (M, V) == (30720, 11500):
        assert plan.splits == 1 and plan.dwdb_grid == (180, 1)
        assert plan.launch_grid(plan.dwdb_grid) == (180, 1, 2)
        assert s * Vp * h * 4 == 45 * 2**20
        assert 0.9 < tfc._wave_fill(180, 132 // 2) == tfc._wave_fill(360, 132)


def test_an_unplaceable_cluster_raises():
    """A launch that finds no place for a cluster (csrc/fused_ce.cu's
    ERR_CLUSTER) raises ClusterError, naming the cluster; another error
    code raises as any launch does; nothing stands in for the kernel."""
    with pytest.raises(tfc.ClusterError, match="no cluster of 2 CTAs"):
        tfc._check_bwd(tfc._ERR_CLUSTER, tfc.DH)
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        tfc._check_bwd(2, tfc.DWDB)
    tfc._check_bwd(0, tfc.DH)


@pytest.mark.parametrize("name,written_logits", [(tfc.FWD, False), (tfc.FWD_MAT, True)])
def test_an_unplaceable_forward_cluster_raises(name, written_logits):
    """The forward's cluster launch (csrc/fused_ce.cuh's ERR_CLUSTER) that
    finds no place raises ClusterError naming the forward and its width;
    another error code raises as any launch does."""
    with pytest.raises(tfc.ClusterError, match="no cluster of 2 CTAs of the forward at H = 1024"):
        tfc._check_fwd(tfc._ERR_CLUSTER, name, 1024, written_logits)
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        tfc._check_fwd(2, name, 1024, written_logits)
    tfc._check_fwd(0, name, 1024, written_logits)


# ----------------------------------------------------------------------
# the written logits' dW/db past 512: column tiles over the same plan
# ----------------------------------------------------------------------

def _dwdb_cover(plan):
    """{(vocab tile, row tile, output column): times stored} by the written
    logits' dW/db launches of ``plan``: one grid over the 512-column tiles
    (one column tile at the fixed widths), the vocab tiles and the splits,
    then one launch of the same vocab tiles and splits for each narrower
    column tile."""
    tiles = list(plan.col_tiles)
    z = max(1, tiles.count(512))
    seen = {}
    launches = [(0, z)] + [(z + i, 1) for i in range(len(tiles) - z)]
    for first, n in launches:
        for (x, k), count in _covered(plan.dwdb_grid, plan.dwdb_k_tiles,
                                      plan.dwdb_per).items():
            for tile in range(first, first + n):
                e0 = sum(tiles[:tile])
                for col in range(e0, e0 + tiles[tile], 64):
                    seen[x, k, col] = seen.get((x, k, col), 0) + count
    return seen


@pytest.mark.parametrize("H", [64, 512, 576, 960, 1000, 1024, 1088, 1536, 2048])
@pytest.mark.parametrize("M,V", [(30720, 11500), (1000, 11519), (77, 301),
                                 (100, 37), (1, 11500), (300, 2000)])
def test_written_logits_dwdb_plan_covers_each_tile_once(M, V, H):
    """Each (vocab tile, row tile, 64-column block of dW) of the written
    logits' dW/db is met by exactly one block that stores it, at every
    padded width (960: 512 + 256 + 128 + 64 columns; 1088: 2 x 512 + 64),
    on odd vocab-tile counts too (V = 301: 5 tiles; V = 37: 1); no block
    lies past V and no split is empty; the partials are [splits, Vp, H]."""
    Hp = tfc.ce_width(H)
    plan = tfc.ce_bwd_plan(M, Hp, V)
    m_tiles, v_tiles = -(-M // 64), -(-V // 64)
    assert plan.dwdb_grid[0] == v_tiles and sum(plan.col_tiles) == Hp
    want = {(v, m, col): 1 for v in range(v_tiles) for m in range(m_tiles)
            for col in range(0, Hp, 64)}
    assert _dwdb_cover(plan) == want
    assert all(y * plan.dwdb_per < m_tiles for y in range(plan.splits))
    assert plan.dw_part == (plan.splits, v_tiles * 64, Hp)
    assert plan.db_part == (plan.splits, v_tiles * 64)
    assert v_tiles * 64 >= tfc.logits_pitch(V)


@pytest.mark.parametrize("M,V", [(30720, 11500), (30720, 300), (1000, 11519),
                                 (77, 301), (100, 37), (1, 11500)])
def test_written_logits_dwdb_waves_and_workspace(M, V):
    """At H = 1024 the written logits' dW/db takes the split count that
    fills the waves of its 2 column tiles' blocks on 132 SMs best (the
    flash plan's count over its 66 cluster places, the same fill), and its
    partials stay within the 128 MiB of partials (one split may exceed it
    alone): at the train shapes one split, 360 blocks in 91% of 3 waves
    (two or three splits fill them no better), a 45 MiB partial."""
    plan = tfc.ce_bwd_plan(M, 1024, V)
    s, rows, h = plan.dw_part
    assert h == 1024 and plan.col_tiles == (512, 512)
    assert s == 1 or s * rows * h * 4 <= tfc._BWD_WORKSPACE
    blocks = plan.dwdb_grid[0] * plan.splits * len(plan.col_tiles)
    best = tfc._wave_fill(blocks, 132)
    for other in range(1, plan.dwdb_k_tiles + 1):
        per = -(-plan.dwdb_k_tiles // other)
        splits = -(-plan.dwdb_k_tiles // per)
        if splits * rows * h * 4 <= tfc._BWD_WORKSPACE or splits == 1:
            fill = tfc._wave_fill(plan.dwdb_grid[0] * splits * 2, 132)
            assert fill <= best + 1e-12 and (fill < best or splits >= plan.splits)
    if (M, V) == (30720, 11500):
        assert plan.splits == 1 and plan.dwdb_grid == (180, 1)
        assert s * rows * h * 4 == 45 * 2**20
        assert 0.9 < best < 0.91 and -(-blocks // 132) == 3
