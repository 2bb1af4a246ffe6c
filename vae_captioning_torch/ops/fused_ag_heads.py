"""AG-prior recognition heads + cluster-vector combine: CUDA kernel
wrappers, their plain version and the autograd Function around them.

Counterpart of ``vae_captioning_tpu/ops/fused_ag_heads.py``.  The AG
encoder head computes per-cluster posteriors and their convex
combination by the image's cluster vector:

    q      = h @ W^T + b                 [N, 2·K·L]  (μ ‖ log σ)
    μ_k    = q[:, :K·L] as [N, K, L],    σ_k = exp(q[:, K·L:]) as [N, K, L]
    q_mean = Σ_k c_v[:, k] · μ_k,        q_std = Σ_k c_v[:, k] · σ_k

W is the ``q_heads`` ``nn.Linear`` weight [2·K·L, H] (the Flax kernel
transposed), read in that layout.  Rounding as ``ag_heads_xla``: h and W
in bf16 with f32 accumulation, f32 bias, exp in f32, c_v rounded through
bf16, the combine in f32.

On CUDA tensors :func:`fused_ag_heads` launches ``csrc/fused_ag_heads.cu``
(forward and backward); the [N, 2·K·L] q never reaches memory in the
forward, and the backward writes dq once in bf16 for its dW and dh
products.  On CPU tensors it
takes :func:`ag_heads_plain`.  The kernels take H in multiples of
``K_STEP``: at other widths the wrapper zero-pads h's and W's columns
(:func:`pad_ag_heads`; exact, the added terms are 0·0), and autograd
slices dh and dW back.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.ops.padding import pad_last, round_up

FWD = "fused_ag_heads_fwd"
BWD = "fused_ag_heads_bwd"
K_STEP = 64              # H must be a multiple of the kernels' H stage
# the forward kernel (csrc/fused_ag_heads.cu, ag_fwd_kernel<NC, RES>): 128
# h rows a block, the latent columns a block may take (the wgmma widths it
# is built for), one block per SM (H100 SXM: 132), and the bytes the
# groups' [2, N, L] f32 partials may take
_FWD_ROWS = 128
_FWD_COLS = (80, 40)
_FWD_SMS = 132
_FWD_WORKSPACE = 64 << 20
# the backward (ag_fwd_kernel<40, RES, true>, then ag_mat_kernel<CT, DW>):
# the dq pass's latent columns a block, its per-warp db partials (one per 16
# rows), the products' 64-row tiles and output-column tiles, and the bytes
# the dh split's [S, Np, H] f32 partials may take
_BWD_COLS = 40
_WARP_ROWS = 16
_TILE = 64
_BWD_CT = (512, 256, 128, 64)
_DH_WORKSPACE = 64 << 20

Pair = Tuple[torch.Tensor, torch.Tensor]


class FwdPlan(NamedTuple):
    """The forward kernel's launch for (N, K, L).  Block (x, y, z) of the
    grid keeps h rows [128x, 128x + 128) and computes latent columns [cols·y,
    cols·y + cols) of clusters [kb·z, min(K, kb·z + kb)), writing group z's
    [2, N, L] partial; a second launch sums the groups in order."""

    cols: int                           # latent columns a block (wgmma N)
    kb: int                             # clusters a group
    grid: Tuple[int, int, int]          # (row tiles, latent tiles, groups)
    part: Tuple[int, int, int, int]     # [groups, 2, N, L] f32

    @property
    def groups(self) -> int:
        return self.grid[2]


@functools.lru_cache(maxsize=None)
def ag_fwd_plan(N: int, K: int, L: int, sms: int = _FWD_SMS) -> FwdPlan:
    """The forward's block shape: the width among ``_FWD_COLS`` that
    computes the fewest padded latent columns (the widest on a tie), and
    the clusters per group that take the fewest cluster slots per SM,
    waves x (clusters a block + half a cluster for its h load and
    partial), among the groupings whose partials fit in
    ``_FWD_WORKSPACE`` bytes (the fewest groups on a tie).  At the train
    shapes (N = 1280, K = 90, L = 150): two latent tiles of 80 columns, 7
    clusters a group, 13 groups: 260 blocks, 2 waves of 132 SMs."""
    cols = min(_FWD_COLS, key=lambda c: (-(-L // c) * c, -c))
    m_tiles, l_tiles = -(-N // _FWD_ROWS), -(-L // cols)
    most = max(1, _FWD_WORKSPACE // (2 * N * L * 4))
    kb = _cluster_blocks(m_tiles, l_tiles, K, sms, most)
    groups = -(-K // kb)
    return FwdPlan(cols=cols, kb=kb, grid=(m_tiles, l_tiles, groups),
                   part=(groups, 2, N, L))


class BwdPlan(NamedTuple):
    """The backward's launches for (N, H, K, L).  The dq pass: block (x, y,
    z) of ``dq_grid`` keeps h rows [128x, 128x + 128), takes latent
    columns [cols·y, cols·y + cols) of clusters [kb·z, min(K, kb·z + kb))
    and writes dq, the db partial of each of its warps (rows [16p, 16p +
    16)) and the dc_v partial of its latent tile.  dW: block (x, y) of
    ``dw_grid`` writes dW rows [64x, 64x + 64), columns [ct·y, ct·y + ct),
    over every row of h.  dh: block (x, y, s) of ``dh_grid`` writes rows
    [64x, 64x + 64), columns [ct·y, ct·y + ct) of split s's partial, over
    dq's 64-column tiles [per·s, per·s + per)."""

    cols: int                           # dq pass: latent columns a block
    kb: int                             # dq pass: clusters a block
    dq_grid: Tuple[int, int, int]
    ct: int                             # the products' output columns a block
    per: int                            # dh: contraction tiles a split
    dw_grid: Tuple[int, int, int]
    dh_grid: Tuple[int, int, int]
    db_part: Tuple[int, int]            # [8·ceil(N / 128), 2KL] f32
    dcv_part: Tuple[int, int, int]      # [ceil(L / cols), N, K] f32
    dh_part: Tuple[int, int, int]       # [S, Np, H] f32, Np = 64·ceil(N / 64)

    @property
    def splits(self) -> int:
        return self.dh_grid[2]


def _cluster_blocks(m_tiles: int, l_tiles: int, K: int, sms: int,
                    most_groups: int) -> int:
    """Clusters a block: the fewest cluster slots per SM, waves x
    (clusters a block + half a cluster for its h load and epilogue), among
    the groupings of at most ``most_groups`` groups (the fewest groups on
    a tie); K when none fits."""
    best = None
    for kb in range(K, 0, -1):
        groups = -(-K // kb)
        if groups > most_groups or -(-K // groups) != kb:
            continue                    # too many groups, or another kb's split
        cost = -(-(m_tiles * l_tiles * groups) // sms) * (2 * kb + 1)
        if best is None or cost < best[0]:
            best = (cost, kb)
    return K if best is None else best[1]


@functools.lru_cache(maxsize=None)
def ag_bwd_plan(N: int, H: int, K: int, L: int, sms: int = _FWD_SMS) -> BwdPlan:
    """The dq pass at 40 latent columns with the clusters a block that
    fill the SMs best (as :func:`ag_fwd_plan` weighs them); the products'
    column tile, the widest of ``_BWD_CT`` that divides H; dh's split of
    the contraction into the most ranges that keep one wave of blocks (at
    least one range) and its partials within ``_DH_WORKSPACE`` bytes.  At
    the train shapes (N = 1280, H = 512, K = 90, L = 150): 4 latent tiles,
    7 clusters a block (13 groups, 520 blocks); dW 422 blocks; dh 6
    splits of 71 tiles, 120 blocks."""
    m_tiles, l_tiles = -(-N // _FWD_ROWS), -(-L // _BWD_COLS)
    kb = _cluster_blocks(m_tiles, l_tiles, K, sms, K)
    ct = next(c for c in _BWD_CT if H % c == 0)
    C2 = 2 * K * L
    c_tiles, n_tiles = -(-C2 // _TILE), -(-N // _TILE)
    base = n_tiles * (H // ct)
    splits = max(1, min(c_tiles, sms // base,
                        _DH_WORKSPACE // (n_tiles * _TILE * H * 4)))
    per = -(-c_tiles // splits)
    splits = -(-c_tiles // per)
    return BwdPlan(cols=_BWD_COLS, kb=kb, dq_grid=(m_tiles, l_tiles, -(-K // kb)),
                   ct=ct, per=per, dw_grid=(c_tiles, H // ct, 1),
                   dh_grid=(n_tiles, H // ct, splits),
                   db_part=(m_tiles * _FWD_ROWS // _WARP_ROWS, C2),
                   dcv_part=(l_tiles, N, K), dh_part=(splits, n_tiles * _TILE, H))


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------

def ag_heads_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   c_v: torch.Tensor, operands: torch.dtype = torch.bfloat16
                   ) -> Pair:
    """The maths of ``ag_heads_xla``, differentiable by autograd: h [N, H],
    w [2·K·L, H], b [2·K·L], c_v [N, K] → (q_mean, q_std), each [N, L]
    f32.  It materialises q [N, 2·K·L] in f32 (138 MB at the train
    shapes) and its two [N, K, L] views; the gradients of h, w and c_v
    come back rounded to bf16, as the reference's casts round them.
    Under ``operands`` = f32 (the f32 compute path, the JAX package's f32
    XLA heads) nothing is rounded to bf16."""
    N, K = c_v.shape
    KL = w.shape[0] // 2
    L = KL // K
    q = h.to(operands).float() @ w.to(operands).float().t() + b.float()
    means = q[:, :KL].reshape(N, K, L)
    stds = torch.exp(q[:, KL:]).reshape(N, K, L)
    cv16 = c_v.to(operands).float()
    return (torch.einsum("nk,nkl->nl", cv16, means),
            torch.einsum("nk,nkl->nl", cv16, stds))


def ag_heads_bwd_plain(h, w, b, c_v, g_mean, g_std):
    """(dh, dW, db, dc_v) of :func:`ag_heads_plain` for the output
    cotangents (g_mean, g_std), by autograd (it recomputes the forward)."""
    leaves = [t.detach().requires_grad_() for t in (h, w, b, c_v)]
    with torch.enable_grad():
        outs = ag_heads_plain(*leaves)
        return torch.autograd.grad(outs, leaves, (g_mean, g_std))


# ----------------------------------------------------------------------
# kernel launches
# ----------------------------------------------------------------------

def _check(h, w, b, c_v) -> Tuple[int, int, int, int]:
    """Raise on what the kernels do not take; returns (N, H, K, L)."""
    req = _ext.require
    req(h.dim() == 2 and w.dim() == 2 and b.dim() == 1 and c_v.dim() == 2,
        "fused_ag_heads: h [N, H], w [2·K·L, H], b [2·K·L], c_v [N, K]")
    N, H = h.shape
    K = c_v.shape[1]
    req(c_v.shape[0] == N and w.shape[1] == H and w.shape[0] % (2 * K) == 0
        and b.shape == (w.shape[0],),
        f"fused_ag_heads: shapes h{tuple(h.shape)} w{tuple(w.shape)} "
        f"b{tuple(b.shape)} c_v{tuple(c_v.shape)} disagree")
    req(H % K_STEP == 0, f"fused_ag_heads: H={H} must be a multiple of "
        f"{K_STEP} (the kernels' H stage)")
    req(N > 0, "fused_ag_heads: no rows")
    return N, H, K, w.shape[0] // (2 * K)


def prepare(h, w, b, c_v):
    """The kernels' operands: h, w in bf16 (cast once per call), b and
    c_v in f32, all contiguous."""
    return (h.to(torch.bfloat16).contiguous(), w.to(torch.bfloat16).contiguous(),
            b.float().contiguous(), c_v.float().contiguous())


def ag_heads_fwd_kernel(h16, w16, b, cv) -> Pair:
    """The forward kernel on prepared operands → (q_mean, q_std) f32."""
    N, H, K, L = _check(h16, w16, b, cv)
    dev = h16.device
    plan = ag_fwd_plan(N, K, L, _ext.sm_count(dev.index))
    part = torch.empty(plan.part, dtype=torch.float32, device=dev)
    out = torch.empty((2, N, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ag_heads_fwd(
            h16.data_ptr(), w16.data_ptr(), b.data_ptr(), cv.data_ptr(),
            part.data_ptr(), out.data_ptr(), N, H, K, L, plan.kb, plan.cols,
            _ext.stream_ptr(dev))
    _ext.check_launch(err, FWD)
    _ext.LAUNCHES[FWD] += 1
    return out[0], out[1]


def ag_heads_bwd_kernel(h16, w16, b, cv, g_mean, g_std):
    """The backward kernels on prepared operands → (dh, dW, db, dc_v)
    f32.  dq is a bf16 workspace [N, 2·K·L] (69 MB at the train shapes)."""
    N, H, K, L = _check(h16, w16, b, cv)
    plan = ag_bwd_plan(N, H, K, L, _ext.sm_count(h16.device.index))
    gm = g_mean.float().contiguous()
    gs = g_std.float().contiguous()
    _ext.require(gm.shape == gs.shape == (N, L) and gm.device == h16.device,
                 f"fused_ag_heads: gradient shapes {tuple(gm.shape)}, "
                 f"{tuple(gs.shape)} != {(N, L)}")
    dev = h16.device
    C2 = 2 * K * L
    ldq = -(-C2 // 8) * 8
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.empty((N, ldq), dtype=torch.bfloat16, device=dev)
    db_part = torch.empty(plan.db_part, **f32)
    dcv_part = torch.empty(plan.dcv_part, **f32)
    dh_part = torch.empty(plan.dh_part, **f32)
    # dW and dh in whole 64-row tiles (the kernels store every row)
    dw = torch.empty((plan.dw_grid[0] * _TILE, H), **f32)
    db = torch.empty((C2,), **f32)
    dcv = torch.empty((N, K), **f32)
    dh = torch.empty((plan.dh_grid[0] * _TILE, H), **f32)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_ag_heads_bwd(
            h16.data_ptr(), w16.data_ptr(), b.data_ptr(), cv.data_ptr(),
            gm.data_ptr(), gs.data_ptr(), dq.data_ptr(), ldq,
            db_part.data_ptr(), dcv_part.data_ptr(), dh_part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dcv.data_ptr(), dh.data_ptr(),
            N, H, K, L, plan.kb, plan.cols, plan.ct, plan.per,
            _ext.stream_ptr(dev))
    _ext.check_launch(err, BWD)
    _ext.LAUNCHES[BWD] += 1
    return dh[:N], dw[:C2], db, dcv


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------

class _FusedAGHeads(torch.autograd.Function):
    """Inputs h [N, H], w [2·K·L, H], b [2·K·L], c_v [N, K] on one CUDA
    device; outputs (q_mean, q_std) f32.  The backward returns dh, dW, db
    and, when c_v requires grad, dc_v, as the TPU kernel emits all four."""

    @staticmethod
    def forward(ctx, h, w, b, c_v):
        ops = prepare(h, w, b, c_v)
        mean, std = ag_heads_fwd_kernel(*ops)
        ctx.save_for_backward(*ops)
        ctx.dtypes = (h.dtype, w.dtype, b.dtype, c_v.dtype)
        return mean, std

    @staticmethod
    def backward(ctx, g_mean, g_std):
        grads = ag_heads_bwd_kernel(*ctx.saved_tensors, g_mean, g_std)
        return tuple(g.to(dt) if need else None for g, dt, need in
                     zip(grads, ctx.dtypes, ctx.needs_input_grad))


def pad_ag_heads(h: torch.Tensor, w: torch.Tensor, multiple: int = K_STEP
                 ) -> Pair:
    """(h [N, H], w [2·K·L, H]) with H zero-padded up to a multiple of
    ``multiple``; differentiable."""
    Hp = round_up(h.shape[1], multiple)
    return pad_last(h, Hp), pad_last(w, Hp)


def fused_ag_heads(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   c_v: torch.Tensor) -> Pair:
    """The AG heads and combine, differentiable: h [N, H], w [2·K·L, H]
    (the ``q_heads`` weight), b [2·K·L], c_v [N, K] → (q_mean, q_std),
    each [N, L] f32.  CPU tensors take :func:`ag_heads_plain`; CUDA
    tensors launch the kernels (at H padded to a multiple of 64) or
    raise."""
    if _ext.on_cpu(h, w, b, c_v):
        return ag_heads_plain(h, w, b, c_v)
    if (h.dim() == w.dim() == 2 and h.shape[1] == w.shape[1]
            and h.shape[1] % K_STEP):
        h, w = pad_ag_heads(h, w)
    _check(h, w, b, c_v)
    return _FusedAGHeads.apply(h, w, b, c_v)
