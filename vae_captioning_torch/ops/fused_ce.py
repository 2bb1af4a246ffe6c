"""Linear cross-entropy: CUDA kernel wrappers, their plain versions and
the autograd Functions around them, under the three schedules of the JAX
package's ``vae_captioning_tpu/ops/fused_ce.py``.  For hidden rows h [M,
H], the ``rnn_logits`` weight W [V, H] (the Flax kernel transposed, read
in that layout), bias b [V], labels [M] and row weights [M]:

    S    = h16 @ W16^T + b             f32 accumulation, f32 bias
    loss = Σ_i weights_i · (logsumexp(S_i) − S_i[labels_i])

and its gradients by the TPU kernels' VJP: with gw = g·weights and
dl = (softmax(S) − onehot(labels))·gw in f32, dl is rounded to bf16
before both products, dh = dl16 @ W16 and dW = dl16^T @ h16 (f32
accumulation), db = Σ_rows dl from the f32 dl, and d weights = g·(lse −
S[label]).  Rows of weight 0 may carry any label and get dh = 0 exactly.

* The flash CE (``Config.fused_ce``, :func:`fused_linear_ce`):
  ``csrc/fused_ce.cu``'s forward kernel and, in the backward, the dh and
  dW/db kernels, which recompute the logits tiles, so the [M, V] logits
  never reach memory (707 MB in bf16 at the train shapes).
* The hybrid (``Config.ce_hybrid``, :func:`fused_linear_ce_hybrid`):
  ``csrc/fused_ce_mat.cu``'s forward writes the bf16 logits lg [M, Vp]
  (Vp = V rounded up to 64 columns, pad columns −1e30) beside lse and the
  label logit, both taken from the f32 S; its dh and dW/db kernels form dl
  from lg (p = exp(f32(lg) − lse)) instead of recomputing the product.
* The XLA forward (``Config.ce_xla_bwd``, :func:`fused_linear_ce_xla_bwd`):
  a plain forward that rounds as the logits head does, lg = bf16(bf16(h16
  @ W16^T) + bf16(b)), lse and the label logit from lg, then the hybrid's
  two backward kernels over that lg.

On CPU tensors each wrapper takes its plain twin (``*_plain``), which
carries the same VJP; on CUDA tensors it launches its kernels or raises.
The kernels take H in ``KERNEL_H`` (64, 128, 256, 512: built with the
width at compile time) and, past 512, every multiple of 64 up to
``CE_H_MAX`` (4096): the forward on 64-row blocks, resident or streamed
(:func:`fwd_block`), the resident ones as clusters of two CTAs along M
that share each W box by TMA multicast (:func:`fwd_cluster`), both
backwards on output column tiles (:func:`col_tiles`), except the flash
backward at 1024, whose two column halves are the two CTAs of a cluster
(:func:`bwd_cluster`).  The wrappers zero-pad h's and W's columns up to
the width :func:`ce_width` gives (the next of ``KERNEL_H`` below 512, the
next multiple of 64 past it: 520 -> 576, 1000 -> 1024; :func:`pad_ce`;
exact, the added terms are 0·0) and autograd slices dh and dW back.  Past ``CE_H_MAX`` they raise.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vae_captioning_torch import _ext
from vae_captioning_torch.ops.padding import next_width, pad_last, round_up

FWD = "fused_linear_ce_fwd"
DH = "fused_linear_ce_dh"
DWDB = "fused_linear_ce_dwdb"
FWD_MAT = "fused_linear_ce_mat_fwd"
DH_MAT = "fused_linear_ce_mat_dh"
DWDB_MAT = "fused_linear_ce_mat_dwdb"
NEG = -1e30         # the written logit of a vocab column past V
KERNEL_H = (64, 128, 256, 512)  # the widths built at compile time
# past 512 the kernels take every multiple of CE_H_STEP up to CE_H_MAX, the
# widest width the card checks run (chip_smoke.py's CE kernel phases)
CE_H_STEP = 64
CE_H_MAX = 4096
_PITCH_COLS = 64    # the written logits' row pitch is a multiple of this
# the forward kernel (csrc/fused_ce.cuh, ce_fwd_kernel): blocks of 128 or
# 64 h rows (fwd_block), 128-column vocab tiles, one block per SM, and the
# bytes its per-chunk (m, s, ll) partials may take
_FWD_TILE_V = 128
_FWD_WORKSPACE = 16 << 20
# the forward's clusters past 512 (csrc/fused_ce.cuh, FWD_CLUSTER): the
# CTAs of a cluster along M, and the widest width that runs them (the
# widest whose 64 rows stay resident: fwd_block), flash and written logits
FWD_CLUSTER = 2
_FWD_CLUSTER_H = {False: 1280, True: 1152}
# the backward kernels' output column tiles past 512 (col_tiles)
_COL_TILES = (512, 256, 128, 64)
# the flash backward's cluster kernel (csrc/fused_ce.cu, ce_bwd_cluster_kernel):
# a cluster's extent over its grid (Q tiles, K ranges, column halves of H):
# one Q tile, two CTAs that hold 512 of the H columns each; and the one width
# it takes (bwd_cluster)
BWD_CLUSTER = (1, 1, 2)
BWD_CLUSTER_H = 1024
# what its launch returns where the card cannot place a cluster
_ERR_CLUSTER = 20001
# the backward kernels of both schedules (csrc/fused_ce.cu, ce_bwd_kernel;
# csrc/fused_ce_mat.cu, ce_mat_bwd_kernel): 64-row tiles of h and of W,
# one block per SM (H100 SXM: 132), and the bytes the dW/db row splits'
# f32 partials may take
_BWD_TILE = 64
_BWD_SMS = 132
_BWD_WORKSPACE = 128 << 20

Pair = Tuple[torch.Tensor, torch.Tensor]
CEFn = Callable[..., torch.Tensor]   # (h, w, b, labels, weights) → loss


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------

def _logits(h, w, b) -> torch.Tensor:
    """S [M, V] f32 from bf16 operands with f32 accumulation, f32 bias."""
    return (h.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t()
            + b.float())


def _label_cols(labels: torch.Tensor, V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels clamped into [0, V), 1.0 where the label is a column else
    0.0): a row whose label is no column picks nothing, as in the kernels."""
    valid = (labels >= 0) & (labels < V)
    return torch.where(valid, labels, 0).long(), valid.float()


def _lse_ll(S: torch.Tensor, labels: torch.Tensor) -> Pair:
    """(logsumexp(S), S[label]) per row of the f32 S; ll = 0 for a label
    that is no column."""
    cols, valid = _label_cols(labels, S.shape[1])
    return torch.logsumexp(S, dim=1), S.gather(1, cols[:, None])[:, 0] * valid


def ce_fwd_plain(h, w, b, labels) -> Pair:
    """The forward kernel's function: (lse, ll) [M] f32, ll = S[label]
    (0 for a label that is no column)."""
    return _lse_ll(_logits(h, w, b), labels)


def _dl_plain(h, w, b, labels, lse, gw) -> torch.Tensor:
    """dl = (exp(S − lse) − onehot(labels))·gw [M, V] f32, formed as the
    kernels form it."""
    p = torch.exp(_logits(h, w, b) - lse[:, None])
    cols, valid = _label_cols(labels, p.shape[1])
    p[torch.arange(p.shape[0], device=p.device), cols] -= valid
    return p * gw[:, None]


def ce_dh_plain(h, w, b, labels, lse, gw) -> torch.Tensor:
    """The dh kernel's function: bf16(dl) @ W16 [M, H] f32."""
    dl16 = _dl_plain(h, w, b, labels, lse, gw).to(torch.bfloat16).float()
    return dl16 @ w.to(torch.bfloat16).float()


def ce_dwdb_plain(h, w, b, labels, lse, gw) -> Pair:
    """The dW/db kernel's function: (bf16(dl)^T @ h16 [V, H], Σ_rows dl
    [V]), f32."""
    dl = _dl_plain(h, w, b, labels, lse, gw)
    dl16 = dl.to(torch.bfloat16).float()
    return dl16.t() @ h.to(torch.bfloat16).float(), dl.sum(dim=0)


def _grads(ctx, g, lse, ll, grads):
    """The backward's outputs: (dh, dW, db) cast to their inputs' types,
    no label gradient, and d weights = g·(lse − ll)."""
    out = [t.to(dt) if need else None for t, dt, need in
           zip(grads, ctx.dtypes, ctx.needs_input_grad)]
    dweights = (g * (lse - ll)).to(ctx.dtypes[3]) if ctx.needs_input_grad[4] else None
    return (*out, None, dweights)


class _PlainLinearCE(torch.autograd.Function):
    """The plain version with the TPU kernels' VJP (dl rounded to bf16
    before both products), not autograd of the f32-logits formula, whose
    dh would skip that rounding.  The backward recomputes the logits for
    dh and again for dW/db, as the two kernels do."""

    @staticmethod
    def forward(ctx, h, w, b, labels, weights):
        lse, ll = ce_fwd_plain(h, w, b, labels)
        ctx.save_for_backward(h, w, b, labels, weights, lse, ll)
        ctx.dtypes = (h.dtype, w.dtype, b.dtype, weights.dtype)
        return (weights.float() * (lse - ll)).sum()

    @staticmethod
    def backward(ctx, g):
        h, w, b, labels, weights, lse, ll = ctx.saved_tensors
        gw = g * weights.float()
        grads = (ce_dh_plain(h, w, b, labels, lse, gw),
                 *ce_dwdb_plain(h, w, b, labels, lse, gw))
        return _grads(ctx, g, lse, ll, grads)


def fused_linear_ce_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          labels: torch.Tensor, weights: torch.Tensor
                          ) -> torch.Tensor:
    """The flash CE's function in plain PyTorch, on any device: h [M, H],
    w [V, H], b [V], labels [M] int, weights [M] → the scalar loss f32.
    It writes the [M, V] logits in f32 (1.4 GB at the train shapes)."""
    return _PlainLinearCE.apply(h, w, b, labels, weights)


# ----------------------------------------------------------------------
# kernel launches
# ----------------------------------------------------------------------

def kernel_width(H: int) -> bool:
    """Whether the kernels take width H: one of ``KERNEL_H``, or past 512
    a multiple of ``CE_H_STEP`` up to ``CE_H_MAX``."""
    return H in KERNEL_H or (KERNEL_H[-1] < H <= CE_H_MAX and H % CE_H_STEP == 0)


def _width_rule(H: int) -> str:
    return (f"H={H} must be one of {KERNEL_H} or, past {KERNEL_H[-1]}, a "
            f"multiple of {CE_H_STEP} up to {CE_H_MAX}, the widest the kernels "
            "take (the wrappers pad any H up to the next such width)")


def ce_width(H: int) -> int:
    """The width the wrappers pad H to: the next of ``KERNEL_H`` up to
    512, past it the next multiple of ``CE_H_STEP`` (520 -> 576, 1000 ->
    1024); ValueError past ``CE_H_MAX``."""
    if H <= KERNEL_H[-1]:
        return next_width(H, KERNEL_H)
    _ext.require(H <= CE_H_MAX, f"fused_linear_ce: {_width_rule(H)}")
    return round_up(H, CE_H_STEP)


def _check(h, w, b, labels) -> Tuple[int, int, int]:
    """Raise on what the kernels do not take; returns (M, H, V)."""
    req = _ext.require
    req(h.dim() == 2 and w.dim() == 2 and b.dim() == 1 and labels.dim() == 1,
        "fused_linear_ce: h [M, H], w [V, H], b [V], labels [M]")
    M, H = h.shape
    V = w.shape[0]
    req(w.shape[1] == H and b.shape == (V,) and labels.shape == (M,),
        f"fused_linear_ce: shapes h{tuple(h.shape)} w{tuple(w.shape)} "
        f"b{tuple(b.shape)} labels{tuple(labels.shape)} disagree")
    req(kernel_width(H), f"fused_linear_ce: {_width_rule(H)}")
    req(M > 0 and V > 0, "fused_linear_ce: no rows or no vocabulary")
    return M, H, V


def prepare(h, w, b, labels):
    """The kernels' operands: h, w in bf16 (cast once per call), b f32,
    labels int32, all contiguous."""
    return (h.to(torch.bfloat16).contiguous(), w.to(torch.bfloat16).contiguous(),
            b.float().contiguous(), labels.to(torch.int32).contiguous())


class FwdPlan(NamedTuple):
    """The forward kernel's launch for (M, V) on blocks of ``rows`` rows,
    under both schedules (the flash forward and the written-logits one
    are one template).  Block (x, y) of the grid takes h rows [rows·x,
    rows·(x + 1)) and streams the 128-column vocab tiles [y·chunk_tiles,
    min(v_tiles, (y + 1)·chunk_tiles)), writing chunk y's (max, sum-exp,
    label logit) of its rows to ``part``, one partial a chunk (128 rows)
    or one a chunk and warpgroup (64 rows, whose two warpgroups take a
    tile's columns in halves); a merge launch folds the partials in
    order."""

    grid: Tuple[int, int]               # (row blocks, chunks)
    v_tiles: int
    chunk_tiles: int
    part: Tuple[int, int, int]          # [partials, M, 3] f32
    rows: int                           # 128 or 64
    cluster: int = 0                    # the CTAs of a cluster along M (fwd_cluster)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def fwd_block(H: int, written_logits: bool = False) -> Tuple[int, bool]:
    """(rows, resident) of the forward kernel's blocks at width H, as
    ``csrc/fused_ce.cuh``'s ``fwd_block`` chooses it from ``row_ring.cuh``'s
    shared-memory layout (``vct_fused_ce_fwd_block``): 128 rows resident at
    ``KERNEL_H``; past 512 64 rows, resident where they fit beside a ring
    of four W boxes (H <= 1280, written logits 1152), else streamed."""
    code = _ext.library().vct_fused_ce_fwd_block(H, int(written_logits))
    _ext.require(code > 0, f"fused_linear_ce: {_width_rule(H)}")
    return code // 2, bool(code % 2)


def fwd_cluster(H: int, written_logits: bool = False) -> int:
    """The forward's shape rule past 512: the CTAs of a cluster of
    ``ce_fwd_kernel`` at width H (a width the kernels take), 0 where its
    blocks run alone.  Where a 64-row block keeps its rows resident (H <=
    1280, written logits 1152: :func:`fwd_block`), ``FWD_CLUSTER`` (2)
    adjacent blocks of one vocab chunk share every W box: each loads half
    of it by TMA multicast into both, so W is read from L2 once per 128
    rows (5.65 GB a launch at H = 1024 and the train shapes, against 11.3
    alone).  The fixed widths' 128-row blocks and the streamed 64-row ones
    run alone.  ``csrc/fused_ce.cuh`` applies the same rule
    (``fwd_cluster``, exported as ``vct_fused_ce_fwd_cluster``)."""
    clustered = KERNEL_H[-1] < H <= _FWD_CLUSTER_H[written_logits]
    return FWD_CLUSTER if clustered and kernel_width(H) else 0


@functools.lru_cache(maxsize=None)
def ce_fwd_plan(M: int, V: int, sms: int = _BWD_SMS, rows: int = 128,
                cluster: int = 0) -> FwdPlan:
    """The forward's vocab chunks for blocks of ``rows`` (128 or 64) rows,
    in clusters of ``cluster`` CTAs along M (0: none; :func:`fwd_cluster`),
    the row blocks rounded up to whole clusters: the count that takes the
    fewest tile slots per SM, waves x (tiles a block + half a tile for
    its h load and epilogue), the waves counted in the ``sms // cluster``
    clusters the card holds, among the counts whose partials fit in
    ``_FWD_WORKSPACE`` bytes (the fewest on a tie); no chunk is empty.  At
    the train shapes (M = 30720, V = 11500) on 128-row blocks: 6 chunks of
    15 of the 90 tiles, 1,440 blocks in 99% of 11 waves of 132 SMs (one
    chunk: 240 blocks in 91% of 2); on 64-row blocks, alone or in
    clusters of 2, 3 chunks of 30."""
    _ext.require(rows in (64, 128), f"ce_fwd_plan: rows={rows} is not 64 or 128")
    _ext.require(cluster in (0, FWD_CLUSTER),
                 f"ce_fwd_plan: cluster={cluster} is not 0 or {FWD_CLUSTER}")
    ctas = max(cluster, 1)
    per_chunk = 128 // rows             # partials a chunk
    m_tiles = round_up(_cdiv(M, rows), ctas)
    v_tiles = _cdiv(V, _FWD_TILE_V)
    most = max(1, min(v_tiles, _FWD_WORKSPACE // (M * 12 * per_chunk)))
    best = None
    for chunks in range(1, most + 1):
        per = _cdiv(v_tiles, chunks)
        if _cdiv(v_tiles, per) != chunks:
            continue                    # the same split as fewer chunks
        cost = _cdiv(m_tiles // ctas * chunks, sms // ctas) * (2 * per + 1)
        if best is None or cost < best[0]:
            best = (cost, chunks, per)
    _, chunks, per = best
    return FwdPlan(grid=(m_tiles, chunks), v_tiles=v_tiles, chunk_tiles=per,
                   part=(chunks * per_chunk, M, 3), rows=rows, cluster=cluster)


def fwd_plan(M: int, H: int, V: int, dev, written_logits: bool = False) -> FwdPlan:
    """The forward's launch at width H on device ``dev``: its block
    (:func:`fwd_block`), cluster (:func:`fwd_cluster`) and chunks."""
    return ce_fwd_plan(M, V, _sms(dev), fwd_block(H, written_logits)[0],
                       fwd_cluster(H, written_logits))


def fused_ce_fwd_kernel(h16, w16, b, lab) -> Pair:
    """The forward kernel on prepared operands → (lse, ll) [M] f32."""
    M, H, V = _check(h16, w16, b, lab)
    dev = h16.device
    plan = fwd_plan(M, H, V, dev)
    part = torch.empty(plan.part, dtype=torch.float32, device=dev)
    out = torch.empty((2, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ce_fwd(
            h16.data_ptr(), w16.data_ptr(), b.data_ptr(), lab.data_ptr(),
            part.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), M, H, V,
            plan.chunk_tiles, _ext.stream_ptr(dev))
    _check_fwd(err, FWD, H)
    _ext.LAUNCHES[FWD] += 1
    return out[0], out[1]


def _row_args(lse, gw, M, dev):
    lse = lse.float().contiguous()
    gw = gw.float().contiguous()
    _ext.require(lse.shape == gw.shape == (M,) and lse.device == gw.device == dev,
                 f"fused_linear_ce: lse {tuple(lse.shape)}, gw {tuple(gw.shape)} "
                 f"!= ({M},)")
    return lse, gw


class ClusterError(RuntimeError):
    """The card cannot place a cluster of a CE kernel at one block an SM:
    the flash backward's at H = 1024 (two CTAs of 225 KB of shared memory
    each on neighbouring SMs) or the forward's past 512
    (:func:`fwd_cluster`).  Raised; no other kernel stands in."""


class BwdPlan(NamedTuple):
    """The launches of the backward kernels for (M, H, V), under both
    schedules: the flash CE's ce_bwd_kernel (past 512 ce_bwd_wide_kernel,
    or ce_bwd_cluster_kernel where ``cluster``) and the written logits'
    ce_mat_bwd_kernel tile alike.  Block (x, y) of a grid owns output
    tile x (64 rows) and streams tiles [y·per, min(k_tiles, (y + 1)·per))
    of the other operand.  dh: h tiles, every W tile in one range (per =
    k_tiles).  dW/db: W tiles, streamed h tiles in ``splits`` ranges whose
    f32 partials are summed in range order.  Each grid runs once for each
    output column tile of ``col_tiles`` (one of H at H <= 512); under the
    flash CE at ``cluster`` > 0 the column tiles are instead the CTAs of
    one launch's clusters of ``BWD_CLUSTER``: grid (x, y, 2), CTA z
    holding column tile z (:meth:`launch_grid`)."""

    dh_grid: Tuple[int, int]
    dh_k_tiles: int
    dh_rows: int                        # dh's rows: M rounded up to 64
    dwdb_grid: Tuple[int, int]
    dwdb_k_tiles: int
    dwdb_per: int
    dw_part: Tuple[int, int, int]       # [splits, Vp, H] f32
    db_part: Tuple[int, int]            # [splits, Vp] f32
    col_tiles: Tuple[int, ...]          # output columns of each tile, in order
    cluster: int = 0                    # the flash CE's cluster CTAs (bwd_cluster)

    @property
    def splits(self) -> int:
        return self.dwdb_grid[1]

    def launch_grid(self, grid: Tuple[int, int]) -> Tuple[int, int, int]:
        """The cluster kernel's launch grid over ``grid`` (dh_grid or
        dwdb_grid): Q tiles, K ranges, and the column halves."""
        return (grid[0], grid[1], BWD_CLUSTER[2])


def _wave_fill(blocks: int, sms: int) -> float:
    """The share of ``sms`` x waves that ``blocks`` blocks keep busy, one
    block per SM."""
    return blocks / (_cdiv(blocks, sms) * sms)


def col_tiles(H: int) -> Tuple[int, ...]:
    """The backward kernels' output column tiles at width H, in column
    order, as the kernels' launches take them: H itself at ``KERNEL_H``;
    past 512, tiles of 512 (m64n256 accumulators a warpgroup, as at 512),
    then one each of 256, 128 and 64 for what is left (576 -> 512 + 64,
    1024 -> 512 + 512)."""
    if H in KERNEL_H:
        return (H,)
    _ext.require(kernel_width(H), f"fused_linear_ce: {_width_rule(H)}")
    tiles = [512] * (H // 512)
    rest = H % 512
    for ct in _COL_TILES[1:]:
        if rest >= ct:
            tiles.append(ct)
            rest -= ct
    return tuple(tiles)


def bwd_cluster(H: int) -> int:
    """The flash CE backward's shape rule past 512: the CTAs of a cluster
    of ``ce_bwd_cluster_kernel`` at width H, 0 where another kernel runs.
    At ``BWD_CLUSTER_H`` (1024) two CTAs each hold 512 of the columns of a
    Q tile and of every K tile, form the logits tile's partial over them,
    swap partials through distributed shared memory and multiply dl by
    their own K columns: the logits formed once, each K byte read from L2
    once a cluster.  A third column CTA would add a 16 KB partial to every
    CTA's exchange buffer, which does not fit beside the Q part and two K
    parts in 227 KB; so the other widths past 512 take
    ``ce_bwd_wide_kernel`` (column tiles, each forming the logits again).
    ``csrc/fused_ce.cu`` applies the same rule (``cluster_width``,
    exported as ``vct_fused_ce_bwd_cluster``)."""
    return BWD_CLUSTER[0] * BWD_CLUSTER[1] * BWD_CLUSTER[2] if H == BWD_CLUSTER_H else 0


@functools.lru_cache(maxsize=None)
def ce_bwd_plan(M: int, H: int, V: int, sms: int = _BWD_SMS) -> BwdPlan:
    """The backward's grids, row splits, column tiles, cluster and
    workspace shapes.  The dW/db split count fills the card's waves best
    (the blocks of every column tile counted; under a cluster, clusters
    over ``sms // cluster`` places) among the counts whose partials fit
    in ``_BWD_WORKSPACE`` bytes (the fewest on a tie); no split is empty.  At the train shapes (M = 30720, H = 512, V = 11500)
    that is 5 splits of 96 row tiles: 900 blocks, 97% of 7 waves, a 112.5
    MiB workspace; at H = 1024 one split (two fill the waves no better) of
    180 clusters of 2 CTAs (the flash CE; the written logits: 2 column
    tiles, 360 blocks), 91% of 3 waves, a 45 MiB workspace."""
    T = _BWD_TILE
    m_tiles, v_tiles = _cdiv(M, T), _cdiv(V, T)
    Vp = v_tiles * T
    cols = col_tiles(H)
    cluster = bwd_cluster(H)
    most = max(1, min(m_tiles, _BWD_WORKSPACE // (Vp * H * 4)))
    best = (0.0, 1, m_tiles)
    for want in range(1, most + 1):
        per = _cdiv(m_tiles, want)
        splits = _cdiv(m_tiles, per)
        fill = (_wave_fill(v_tiles * splits, sms // cluster)
                if cluster else _wave_fill(v_tiles * splits * len(cols), sms))
        if fill > best[0]:
            best = (fill, splits, per)
    _, splits, per = best
    return BwdPlan(dh_grid=(m_tiles, 1), dh_k_tiles=v_tiles,
                   dh_rows=m_tiles * T, dwdb_grid=(v_tiles, splits),
                   dwdb_k_tiles=m_tiles, dwdb_per=per,
                   dw_part=(splits, Vp, H), db_part=(splits, Vp), col_tiles=cols,
                   cluster=cluster)


def _check_cluster(err: int, name: str, ctas: int, what: str) -> None:
    """Raise ClusterError where a cluster launch found no place for a
    cluster of ``ctas`` CTAs of ``what``, as any launch on another error."""
    if err == _ERR_CLUSTER:
        raise ClusterError(f"{name}: the card holds no cluster of {ctas} CTAs of {what} "
                           "(cudaOccupancyMaxActiveClusters is 0)")
    _ext.check_launch(err, name)


def _check_bwd(err: int, name: str) -> None:
    _check_cluster(err, name, bwd_cluster(BWD_CLUSTER_H),
                   f"the backward at H = {BWD_CLUSTER_H}")


def _check_fwd(err: int, name: str, H: int, written_logits: bool = False) -> None:
    _check_cluster(err, name, fwd_cluster(H, written_logits), f"the forward at H = {H}")


def fused_ce_dh_kernel(h16, w16, b, lab, lse, gw) -> torch.Tensor:
    """The dh kernel on prepared operands → dh [M, H] f32."""
    M, H, V = _check(h16, w16, b, lab)
    dev = h16.device
    lse, gw = _row_args(lse, gw, M, dev)
    plan = ce_bwd_plan(M, H, V)
    dh = torch.empty((plan.dh_rows, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ce_dh(
            h16.data_ptr(), w16.data_ptr(), b.data_ptr(), lab.data_ptr(),
            lse.data_ptr(), gw.data_ptr(), dh.data_ptr(), M, H, V,
            _ext.stream_ptr(dev))
    _check_bwd(err, DH)
    _ext.LAUNCHES[DH] += 1
    return dh[:M]


def fused_ce_dwdb_kernel(h16, w16, b, lab, lse, gw) -> Pair:
    """The dW/db kernels on prepared operands → (dW [V, H], db [V]) f32.
    The row splits' partials are workspaces of [splits, Vp, H] f32
    (:func:`ce_bwd_plan`; 112.5 MiB at the train shapes)."""
    M, H, V = _check(h16, w16, b, lab)
    dev = h16.device
    lse, gw = _row_args(lse, gw, M, dev)
    plan = ce_bwd_plan(M, H, V, _sms(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    dw_part = torch.empty(plan.dw_part, **f32)
    db_part = torch.empty(plan.db_part, **f32)
    dw = torch.empty((V, H), **f32)
    db = torch.empty((V,), **f32)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ce_dwdb(
            h16.data_ptr(), w16.data_ptr(), b.data_ptr(), lab.data_ptr(),
            lse.data_ptr(), gw.data_ptr(), dw_part.data_ptr(),
            db_part.data_ptr(), dw.data_ptr(), db.data_ptr(), M, H, V,
            plan.splits, plan.dwdb_per, _ext.stream_ptr(dev))
    _check_bwd(err, DWDB)
    _ext.LAUNCHES[DWDB] += 1
    return dw, db


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------

class _FusedLinearCE(torch.autograd.Function):
    """Inputs h [M, H], w [V, H], b [V], labels [M], weights [M] on one
    CUDA device; output the scalar loss.  The forward launches the forward
    kernel only (the eval step runs it under no_grad); the backward the dh
    and dW/db kernels, each only where its gradient is needed."""

    @staticmethod
    def forward(ctx, h, w, b, labels, weights):
        ops = prepare(h, w, b, labels)
        lse, ll = fused_ce_fwd_kernel(*ops)
        wt = weights.float()
        ctx.save_for_backward(*ops, wt, lse, ll)
        ctx.dtypes = (h.dtype, w.dtype, b.dtype, weights.dtype)
        return (wt * (lse - ll)).sum()

    @staticmethod
    def backward(ctx, g):
        *ops, wt, lse, ll = ctx.saved_tensors
        gw = g * wt
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        dh = fused_ce_dh_kernel(*ops, lse, gw) if need_h else None
        dw, db = (fused_ce_dwdb_kernel(*ops, lse, gw) if need_w or need_b
                  else (None, None))
        return _grads(ctx, g, lse, ll, (dh, dw, db))


def fused_linear_ce(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    labels: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """Σ_i weights_i · CE(softmax(h_i W^T + b), labels_i), differentiable
    in h, w, b and weights: h [M, H], w [V, H] (the ``rnn_logits``
    weight), b [V], labels [M] int, weights [M] → a scalar f32.  CPU
    tensors take :func:`fused_linear_ce_plain`; CUDA tensors launch the
    kernels (at H padded as :func:`ce_width` says) or raise (H >
    ``CE_H_MAX``)."""
    if _ext.on_cpu(h, w, b, labels, weights):
        return fused_linear_ce_plain(h, w, b, labels, weights)
    h, w = _kernel_operands(h, w, b, labels, weights)
    return _FusedLinearCE.apply(h, w, b, labels, weights)


def pad_ce(h: torch.Tensor, w: torch.Tensor) -> Pair:
    """(h [M, H], w [V, H]) with H zero-padded up to :func:`ce_width`;
    differentiable."""
    Hp = ce_width(h.shape[1])
    return pad_last(h, Hp), pad_last(w, Hp)


def _kernel_operands(h, w, b, labels, weights) -> Pair:
    """(h, w) of CUDA tensors at a width the kernels take (padded by
    :func:`pad_ce`); raise on what the kernels do not take (a width past
    ``CE_H_MAX`` among them)."""
    if (h.dim() == w.dim() == 2 and h.shape[1] == w.shape[1]
            and not kernel_width(h.shape[1])):
        h, w = pad_ce(h, w)
    _check(h, w, b, labels)
    _ext.require(weights.shape == labels.shape,
                 f"fused_linear_ce: weights {tuple(weights.shape)} != labels "
                 f"{tuple(labels.shape)}")
    return h, w


# ----------------------------------------------------------------------
# written logits: the hybrid and XLA-forward schedules
# ----------------------------------------------------------------------

def logits_pitch(V: int) -> int:
    """Vp, the written logits' columns: V rounded up to a multiple of 64
    (11,520 for V = 11,500, the JAX package's own pad), so that a row is
    whole 128-byte boxes for the backward's TMA loads.  Not a multiple of
    the forward's 128-column tile: the forward stores only columns < Vp."""
    return _cdiv(V, _PITCH_COLS) * _PITCH_COLS


def ce_mat_fwd_plain(h, w, b, labels) -> Tuple[torch.Tensor, ...]:
    """The hybrid forward kernel's function: (lg [M, Vp] bf16, lse, ll [M]
    f32).  lg is S rounded to nearest even, its pad columns −1e30; lse and
    ll come from the f32 S, as in the TPU kernel."""
    S = _logits(h, w, b)
    lse, ll = _lse_ll(S, labels)
    V = S.shape[1]
    lg = F.pad(S, (0, logits_pitch(V) - V), value=NEG).to(torch.bfloat16)
    return lg, lse, ll


def ce_xla_fwd_plain(h, w, b, labels) -> Tuple[torch.Tensor, ...]:
    """The XLA-forward schedule's forward (JAX ``_fwd_xla``), plain on
    every device: (lg [M, Vp] bf16, lse, ll [M] f32).  The bf16 product is
    rounded to bf16, then the bf16 bias is added and rounded again (a
    separate add: a fused bias epilogue would round once); pad columns get
    W rows of 0 and bias −1e30.  lse = log Σ exp(f32(lg − max)) + max, the
    difference taken in bf16; ll = f32(lg[label])."""
    bf16 = torch.bfloat16
    V = w.shape[0]
    pad = logits_pitch(V) - V
    w16 = F.pad(w.to(bf16), (0, 0, 0, pad))
    b16 = F.pad(b.float(), (0, pad), value=NEG).to(bf16)
    lg = torch.matmul(h.to(bf16), w16.t()) + b16
    m = lg.amax(dim=1, keepdim=True)
    lse = torch.log(torch.exp((lg - m).float()).sum(dim=1)) + m[:, 0].float()
    cols, valid = _label_cols(labels, V)
    ll = lg.gather(1, cols[:, None])[:, 0].float() * valid
    return lg, lse, ll


def _dl_mat_plain(lg16, labels, lse, gw, V: int) -> torch.Tensor:
    """dl [M, V] f32 from the written logits, as the kernels form it: p =
    exp(f32(lg) − lse), the label's column less 1, times gw.  The pad
    columns (p = 0, no label) give 0 and are left out."""
    p = torch.exp(lg16[:, :V].float() - lse[:, None])
    cols, valid = _label_cols(labels, V)
    p[torch.arange(p.shape[0], device=p.device), cols] -= valid
    return p * gw[:, None]


def ce_mat_dh_plain(lg16, w, labels, lse, gw) -> torch.Tensor:
    """The written-logits dh kernel's function: bf16(dl) @ W16 [M, H]
    f32."""
    dl16 = _dl_mat_plain(lg16, labels, lse, gw, w.shape[0]).to(torch.bfloat16)
    return dl16.float() @ w.to(torch.bfloat16).float()


def ce_mat_dwdb_plain(h, lg16, labels, lse, gw, V: int) -> Pair:
    """The written-logits dW/db kernel's function: (bf16(dl)^T @ h16 [V,
    H], Σ_rows dl [V]), f32."""
    dl = _dl_mat_plain(lg16, labels, lse, gw, V)
    dl16 = dl.to(torch.bfloat16).float()
    return dl16.t() @ h.to(torch.bfloat16).float(), dl.sum(dim=0)


def _check_mat(lg, labels, op, V: int) -> int:
    """Raise on operands the backward kernels do not take: lg, labels and
    ``op``, the bf16 [V, H] weight (dh) or [M, H] rows (dW/db); returns
    M."""
    req = _ext.require
    req(lg.dim() == 2 and labels.dim() == 1,
        "fused_linear_ce: written logits lg [M, Vp], labels [M]")
    M = labels.shape[0]
    req(M > 0 and V > 0, "fused_linear_ce: no rows or no vocabulary")
    req(op.dim() == 2 and kernel_width(op.shape[1]),
        f"fused_linear_ce: {tuple(op.shape)}: {_width_rule(op.shape[-1])}")
    Vp = logits_pitch(V)
    req(lg.dtype == torch.bfloat16 and tuple(lg.shape) == (M, Vp),
        f"fused_linear_ce: written logits {tuple(lg.shape)} {lg.dtype} are "
        f"not bf16 ({M}, {Vp}) for V={V}")
    req(labels.dtype == torch.int32 and labels.is_contiguous()
        and op.dtype == torch.bfloat16 and op.is_contiguous(),
        "fused_linear_ce: labels int32 and the bf16 operand contiguous "
        "(as prepare gives them)")
    return M


def ce_mat_fwd_kernel(h16, w16, b, lab) -> Tuple[torch.Tensor, ...]:
    """The written-logits forward kernel on prepared operands → (lg [M,
    Vp] bf16, lse, ll [M] f32)."""
    M, H, V = _check(h16, w16, b, lab)
    dev = h16.device
    plan = fwd_plan(M, H, V, dev, written_logits=True)
    part = torch.empty(plan.part, dtype=torch.float32, device=dev)
    lg = torch.empty((M, logits_pitch(V)), dtype=torch.bfloat16, device=dev)
    out = torch.empty((2, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ce_mat_fwd(
            h16.data_ptr(), w16.data_ptr(), b.data_ptr(), lab.data_ptr(),
            part.data_ptr(), lg.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), M, H, V, plan.chunk_tiles, _ext.stream_ptr(dev))
    _check_fwd(err, FWD_MAT, H, written_logits=True)
    _ext.LAUNCHES[FWD_MAT] += 1
    return lg, out[0], out[1]


def ce_mat_dh_kernel(lg16, w16, lab, lse, gw) -> torch.Tensor:
    """The written-logits dh kernel: lg [M, Vp] bf16, w16 [V, H] bf16,
    labels int32, lse and gw [M] → dh [M, H] f32."""
    V = w16.shape[0]
    M = _check_mat(lg16, lab, w16, V)
    H = w16.shape[1]
    dev = lg16.device
    lg16 = lg16.contiguous()
    lse, gw = _row_args(lse, gw, M, dev)
    plan = ce_bwd_plan(M, H, V)
    dh = torch.empty((plan.dh_rows, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ce_mat_dh(
            lg16.data_ptr(), w16.data_ptr(), lab.data_ptr(), lse.data_ptr(),
            gw.data_ptr(), dh.data_ptr(), M, H, V, _ext.stream_ptr(dev))
    _ext.check_launch(err, DH_MAT)
    _ext.LAUNCHES[DH_MAT] += 1
    return dh[:M]


def ce_mat_dwdb_kernel(h16, lg16, lab, lse, gw, V: int) -> Pair:
    """The written-logits dW/db kernel: h16 [M, H] bf16, lg [M, Vp] bf16,
    labels int32, lse and gw [M] → (dW [V, H], db [V]) f32, through row
    ranges' partials summed in order, as the flash dW/db (the same
    :func:`ce_bwd_plan`; 112.5 MiB of partials at the train shapes).  At
    one split (H = 1024 at the train shapes) dW and db are the first V rows
    of the one partial, and nothing is summed: the same values, but for
    the sign of an element whose every product is a zero (the sum gives
    +0)."""
    M = _check_mat(lg16, lab, h16, V)
    H = h16.shape[1]
    _ext.require(h16.shape[0] == M, f"fused_linear_ce: h {tuple(h16.shape)} "
                 f"and labels ({M},) disagree")
    dev = h16.device
    lg16 = lg16.contiguous()
    lse, gw = _row_args(lse, gw, M, dev)
    plan = ce_bwd_plan(M, H, V, _sms(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    dw_part = torch.empty(plan.dw_part, **f32)
    db_part = torch.empty(plan.db_part, **f32)
    in_place = plan.splits == 1
    dw = dw_part[0, :V] if in_place else torch.empty((V, H), **f32)
    db = db_part[0, :V] if in_place else torch.empty((V,), **f32)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ce_mat_dwdb(
            h16.data_ptr(), lg16.data_ptr(), lab.data_ptr(), lse.data_ptr(),
            gw.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
            None if in_place else dw.data_ptr(), None if in_place else db.data_ptr(),
            M, H, V, plan.splits, plan.dwdb_per, _ext.stream_ptr(dev))
    _ext.check_launch(err, DWDB_MAT)
    _ext.LAUNCHES[DWDB_MAT] += 1
    return dw, db


class MatFns(NamedTuple):
    """A written-logits schedule: its forward (h16, w16, b, labels) → (lg,
    lse, ll) and its backward functions, dh (lg, w16, labels, lse, gw) and
    dW/db (h16, lg, labels, lse, gw, V)."""

    fwd: Callable
    dh: Callable
    dwdb: Callable


HYBRID_PLAIN = MatFns(ce_mat_fwd_plain, ce_mat_dh_plain, ce_mat_dwdb_plain)
HYBRID_KERNELS = MatFns(ce_mat_fwd_kernel, ce_mat_dh_kernel, ce_mat_dwdb_kernel)
XLA_BWD_PLAIN = MatFns(ce_xla_fwd_plain, ce_mat_dh_plain, ce_mat_dwdb_plain)
XLA_BWD_KERNELS = MatFns(ce_xla_fwd_plain, ce_mat_dh_kernel, ce_mat_dwdb_kernel)


class _WrittenLogitsCE(torch.autograd.Function):
    """The JAX custom VJPs ``_fwd_mat`` / ``_fwd_xla`` with ``_bwd_mat``:
    the forward writes lg and keeps it (708 MB at the train shapes) with
    h16 and W16 as the residual; the backward forms dl from lg, never
    recomputing h·W.  Under no_grad (the eval step) lg is freed on
    return.  ``fns`` picks the kernels or the plain versions."""

    @staticmethod
    def forward(ctx, h, w, b, labels, weights, fns: MatFns):
        h16, w16, bf, lab = prepare(h, w, b, labels)
        lg, lse, ll = fns.fwd(h16, w16, bf, lab)
        wt = weights.float()
        ctx.save_for_backward(h16, w16, lab, wt, lg, lse, ll)
        ctx.fns = fns
        ctx.dtypes = (h.dtype, w.dtype, b.dtype, weights.dtype)
        return (wt * (lse - ll)).sum()

    @staticmethod
    def backward(ctx, g):
        h16, w16, lab, wt, lg, lse, ll = ctx.saved_tensors
        gw = g * wt
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        dh = ctx.fns.dh(lg, w16, lab, lse, gw) if need_h else None
        dw, db = (ctx.fns.dwdb(h16, lg, lab, lse, gw, w16.shape[0])
                  if need_w or need_b else (None, None))
        return (*_grads(ctx, g, lse, ll, (dh, dw, db)), None)


def _written_logits_ce(kernels: MatFns, plain: MatFns, h, w, b, labels,
                       weights) -> torch.Tensor:
    if _ext.on_cpu(h, w, b, labels, weights):
        return _WrittenLogitsCE.apply(h, w, b, labels, weights, plain)
    h, w = _kernel_operands(h, w, b, labels, weights)
    return _WrittenLogitsCE.apply(h, w, b, labels, weights, kernels)


def fused_linear_ce_hybrid(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           labels: torch.Tensor, weights: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`fused_linear_ce`'s function and arguments under the hybrid
    schedule: CUDA tensors launch ``csrc/fused_ce_mat.cu``'s forward (lg
    written), dh and dW/db kernels, or raise; CPU tensors take
    :func:`fused_linear_ce_hybrid_plain`."""
    return _written_logits_ce(HYBRID_KERNELS, HYBRID_PLAIN, h, w, b, labels,
                              weights)


def fused_linear_ce_hybrid_plain(h, w, b, labels, weights) -> torch.Tensor:
    """The hybrid schedule in plain PyTorch, on any device."""
    return _WrittenLogitsCE.apply(h, w, b, labels, weights, HYBRID_PLAIN)


def fused_linear_ce_xla_bwd(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            labels: torch.Tensor, weights: torch.Tensor
                            ) -> torch.Tensor:
    """:func:`fused_linear_ce`'s function and arguments under the XLA-
    forward schedule: the plain forward :func:`ce_xla_fwd_plain`, then, on
    CUDA tensors, the hybrid's dh and dW/db kernels over its lg (or a
    raise); CPU tensors take :func:`fused_linear_ce_xla_bwd_plain`."""
    return _written_logits_ce(XLA_BWD_KERNELS, XLA_BWD_PLAIN, h, w, b, labels,
                              weights)


def fused_linear_ce_xla_bwd_plain(h, w, b, labels, weights) -> torch.Tensor:
    """The XLA-forward schedule in plain PyTorch, on any device."""
    return _WrittenLogitsCE.apply(h, w, b, labels, weights, XLA_BWD_PLAIN)


def linear_ce(hidden: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              labels: torch.Tensor, ce_fn: Optional[CEFn] = None,
              tokens: Optional[float] = None) -> torch.Tensor:
    """The PAD-masked mean CE through ``ce_fn`` (by default
    :func:`fused_linear_ce`): hidden [..., H] and labels [...] in the
    same layout (time-major [T, B·K] in the train step) are flattened to
    rows, and each row weighs mask / max(Σ mask, 1), mask = labels != 0.
    This is the JAX package's ``kernel_shard.linear_ce``: its row order
    does not depend on the batch axis, and ``tokens``, where given,
    replaces Σ mask: the global count over data-parallel ranks (its
    psummed ``total``)."""
    ce_fn = fused_linear_ce if ce_fn is None else ce_fn
    lab = labels.reshape(-1)
    mask = (lab != 0).float()
    weights = mask / (torch.clamp(mask.sum(), min=1.0) if tokens is None
                      else max(tokens, 1.0))
    return ce_fn(hidden.reshape(-1, hidden.shape[-1]), w, b, lab, weights)
