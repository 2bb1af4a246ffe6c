"""Fused teacher-forcing LSTM layer, forward and backward: CUDA kernel
wrappers, their plain versions and the autograd Function around them.

Counterpart of ``vae_captioning_tpu/ops/fused_lstm_seq.py``.  One call
runs a masked LSTM layer over a whole sequence with ``dynamic_rnn``
semantics: row n steps while t < lengths[n], after which its carry is
copied through and its output is zero.

    gates = x_t @ Wx + bf16(h) @ Wh + b     bf16 operands, f32 accumulation
    c' = sigmoid(f + 1)·c + sigmoid(i)·tanh(g),  h' = sigmoid(o)·tanh(c')

The forward keeps for the backward what the TPU kernel keeps: the h
stack (bf16, zeros at masked steps), the c stack (f32) and the activated
gates (bf16).  The backward rounds where the TPU kernel rounds: dhs in
bf16, the dgates in bf16 for the three products, db from the f32
dgates, and ``h_prev = h0`` at t = 0.  It relies on masks being monotone
per row, which is why it takes lengths and not a mask: a mask built as
t < lengths[n] is monotone for any integer lengths.

On CUDA tensors the wrappers launch ``csrc/fused_lstm_seq.cu``; on CPU
tensors they take :func:`lstm_seq_fwd_plain` / :func:`lstm_seq_bwd_plain`.
The kernels take E and H in multiples of 64: at other widths
:func:`fused_lstm_seq` zero-pads the operands (:func:`pad_lstm_seq`,
exact: padded units stay 0) and slices the outputs back, and autograd
slices the gradients.
:func:`fused_lstm_seq_plain` runs the plain versions on any device.  The
backward's plan (:func:`lstm_seq_plan`: dx's warpgroups, dW's column tile
and row splits, the workspaces) is computed here, so the CPU tests check
it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.ops.padding import (pad_first, pad_gates, pad_last,
                                              round_up)

FWD = "fused_lstm_seq_fwd"
WIDTH_STEP = 64     # the kernels' E and H come in multiples of this
BWD = "fused_lstm_seq_bwd"

Saved = Tuple[torch.Tensor, ...]


def _step_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return (t < lengths).unsqueeze(-1)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def lstm_seq_fwd_plain(x16, wx16, wh16, b, c0, h0, lengths,
                       operands: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The forward kernel's maths in plain PyTorch: x16 [T,N,E], wx16
    [E,4H], wh16 [H,4H] bf16, b [4H], c0/h0 [N,H] f32, lengths [N] int32
    → (hs [T,N,H] bf16, cs [T,N,H] f32, ga [T,N,4H] bf16, h_T [N,H]).
    Under ``operands`` = f32 (the f32 compute path) x, W and h are not
    rounded and hs and ga stay f32."""
    T = x16.shape[0]
    H = c0.shape[1]
    wxf, whf = wx16.float(), wh16.float()
    bf = b.float()
    c, h = c0.float(), h0.float()
    xw = x16.float() @ wxf          # every step's input product at once
    hs, cs, ga = [], [], []
    for t in range(T):
        gates = xw[t] + h.to(operands).float() @ whf + bf
        si = torch.sigmoid(gates[:, :H])
        sf = torch.sigmoid(gates[:, H:2 * H] + 1.0)
        tg = torch.tanh(gates[:, 2 * H:3 * H])
        so = torch.sigmoid(gates[:, 3 * H:])
        nc = sf * c + si * tg
        nh = so * torch.tanh(nc)
        m = _step_mask(lengths, t)
        c = torch.where(m, nc, c)
        h = torch.where(m, nh, h)
        hs.append(torch.where(m, nh, 0.0).to(operands))
        cs.append(c)
        ga.append(torch.cat([si, sf, tg, so], dim=-1).to(operands))
    return torch.stack(hs), torch.stack(cs), torch.stack(ga), h


def lstm_seq_bwd_plain(saved: Saved, dhs, dct, dht
                       ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's maths in plain PyTorch (the TPU
    ``_bwd_kernel``): → (dx [T,N,E], dWx, dWh, db, dc0, dh0), all f32."""
    x16, wx16, wh16, b, c0, h0, lengths, hs, cs, ga = saved
    T = x16.shape[0]
    H = c0.shape[1]
    wxf, whf = wx16.float(), wh16.float()
    dh = dht.float()
    dc = dct.float()
    dhs16 = dhs.to(torch.bfloat16).float()
    dx = torch.empty(x16.shape, dtype=torch.float32, device=x16.device)
    dwx = torch.zeros_like(wxf)
    dwh = torch.zeros_like(whf)
    db = torch.zeros(4 * H, dtype=torch.float32, device=x16.device)
    for t in range(T - 1, -1, -1):
        m = _step_mask(lengths, t)
        g = ga[t].float()
        si, sf, tg, so = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
        c_prev = c0.float() if t == 0 else cs[t - 1]
        h_prev16 = h0.to(torch.bfloat16) if t == 0 else hs[t - 1]
        dnh = torch.where(m, dh + dhs16[t], 0.0)
        tanh_c = torch.tanh(cs[t])
        dnc = dnh * so * (1.0 - tanh_c * tanh_c) + torch.where(m, dc, 0.0)
        dgates = torch.cat([dnc * tg * si * (1.0 - si),
                            dnc * c_prev * sf * (1.0 - sf),
                            dnc * si * (1.0 - tg * tg),
                            dnh * tanh_c * so * (1.0 - so)], dim=-1)
        dg16 = dgates.to(torch.bfloat16).float()
        dh = dg16 @ whf.t() + torch.where(m, 0.0, dh)
        dc = dnc * sf + torch.where(m, 0.0, dc)
        dx[t] = dg16 @ wxf.t()
        dwh += h_prev16.float().t() @ dg16
        dwx += x16[t].float().t() @ dg16
        db += dgates.sum(dim=0)
    return dx, dwx, dwh, db, dc, dh


# ----------------------------------------------------------------------
# kernel launches
# ----------------------------------------------------------------------

# The backward's geometry (csrc/fused_lstm_seq.cu and csrc/mat_ring.cuh):
# 64-row blocks and K tiles, one H100 SXM (132 SMs).  Every launch's shared
# memory is fixed in C at compile time, whatever the shape.
_ROWS = 64
_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class SeqPlan(NamedTuple):
    """What the backward's launches take at (T, N, E, H) beyond the shapes:
    dx = dg @ Wx^T with ``dx_wg`` 64-column warpgroups a block; dWx and dWh
    in output column tiles of ``dw_ct``, the T·N rows in ``k_tiles`` K
    tiles of 64, split z of dWx taking tiles [z·per_x, (z + 1)·per_x) and
    of dWh [z·per_h, (z + 1)·per_h); and the sizes of the workspaces."""

    dx_wg: int
    dw_ct: int
    k_tiles: int
    per_x: int
    per_h: int
    db_parts: int             # T · ceil(N / 64) f32 partials of db
    w_part_rows: int          # rows of the [rows, 4H] f32 dW partials

    def workspace_bytes(self, T: int, N: int, E: int, H: int) -> dict:
        """The bytes of what the kernels need beyond their outputs: the
        forward's bf16 h buffer [T + 1, N, H] (slots 1..T are hs, an
        output; slot 0, bf16(h0), is kept for the backward) and bf16 carry
        [2, N, H] (freed after the call), the backward's dg, dc carry and
        partials."""
        return {"hbuf": (T + 1) * N * H * 2, "hcarry": 2 * N * H * 2,
                "dg": T * N * 4 * H * 2,
                "dcbuf": N * H * 4,
                "db_part": self.db_parts * 4 * H * 4,
                "w_part": self.w_part_rows * 4 * H * 4}


def dw_splits(k_tiles: int, per: int) -> list:
    """The K-tile ranges [start, end) of the dW splits: every one
    non-empty, together every tile once."""
    return [(z * per, min(k_tiles, (z + 1) * per))
            for z in range(_cdiv(k_tiles, per))]


def _per(k_tiles: int, blocks: int, sms: int) -> int:
    """K tiles a split where a split is ``blocks`` blocks of one block an
    SM: as many splits as fill the SMs in one wave, at least one."""
    return _cdiv(k_tiles, max(1, sms // blocks))


@functools.lru_cache(maxsize=None)
def lstm_seq_plan(T: int, N: int, E: int, H: int, sms: int = _SMS) -> SeqPlan:
    """The backward's plan at (T, N, E, H) on ``sms`` SMs.  dx takes two
    64-column warpgroups a block (one A box for both) where E allows it and
    that grid still fills the SMs, else one; dW the widest column tile that
    divides 4H, and the T·N rows split so that each product's grid ((E or
    H) / 64 x 4H / dw_ct x splits) fills the SMs once."""
    k_tiles = _cdiv(T * N, _ROWS)
    dx_wg = 2 if E % 128 == 0 and k_tiles * (E // 128) >= sms else 1
    G = 4 * H
    ct = 512 if G % 512 == 0 else 256
    per_x = _per(k_tiles, (E // 64) * (G // ct), sms)
    per_h = _per(k_tiles, (H // 64) * (G // ct), sms)
    sx, sh = _cdiv(k_tiles, per_x), _cdiv(k_tiles, per_h)
    return SeqPlan(dx_wg=dx_wg, dw_ct=ct, k_tiles=k_tiles, per_x=per_x,
                   per_h=per_h, db_parts=T * _cdiv(N, _ROWS),
                   w_part_rows=max(sx * E, sh * H))


def _check_shapes(x16, wx16, wh16, b, c0, h0, lengths) -> None:
    req = _ext.require
    T, N, E = x16.shape
    H = c0.shape[1]
    req(x16.dtype == wx16.dtype == wh16.dtype == torch.bfloat16,
        "fused_lstm_seq: x, wx and wh must be bfloat16")
    req(b.dtype == c0.dtype == h0.dtype == torch.float32,
        "fused_lstm_seq: b, c0 and h0 must be float32")
    req(lengths.dtype == torch.int32 and lengths.shape == (N,),
        f"fused_lstm_seq: lengths must be int32 [{N}]")
    req(wx16.shape == (E, 4 * H) and wh16.shape == (H, 4 * H)
        and b.shape == (4 * H,) and c0.shape == h0.shape == (N, H),
        f"fused_lstm_seq: shapes x{tuple(x16.shape)} wx{tuple(wx16.shape)} "
        f"wh{tuple(wh16.shape)} b{tuple(b.shape)} c0{tuple(c0.shape)} "
        f"h0{tuple(h0.shape)} disagree")
    req(E % 64 == 0 and H % 64 == 0,
        f"fused_lstm_seq: E={E} and H={H} must be multiples of 64")
    req(T >= 1, "fused_lstm_seq: T must be at least 1")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in (x16, wx16, wh16, b, c0, h0, lengths)),
        "fused_lstm_seq: inputs must be contiguous and 16-byte aligned")


def _fwd_launch(x16, wx16, wh16, b, c0, h0, lengths):
    """The forward's launches → (hbuf [T + 1, N, H] bf16: bf16(h0), hs; cs,
    ga, h_T).  The bf16 h carry [2, N, H] is a workspace of the call."""
    T, N, E = x16.shape
    H = c0.shape[1]
    dev = x16.device
    hbuf = torch.empty((T + 1, N, H), dtype=torch.bfloat16, device=dev)
    hbuf[0].copy_(h0)
    hcarry = torch.empty((2, N, H), dtype=torch.bfloat16, device=dev)
    cs = torch.empty((T, N, H), dtype=torch.float32, device=dev)
    ga = torch.empty((T, N, 4 * H), dtype=torch.bfloat16, device=dev)
    h_t = torch.empty((N, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_lstm_seq_fwd(
            x16.data_ptr(), wx16.data_ptr(), wh16.data_ptr(), b.data_ptr(),
            lengths.data_ptr(), c0.data_ptr(), h0.data_ptr(), hbuf.data_ptr(),
            hcarry.data_ptr(), cs.data_ptr(), ga.data_ptr(), h_t.data_ptr(), T, N, E, H,
            _ext.stream_ptr(dev))
    _ext.check_launch(err, FWD)
    _ext.LAUNCHES[FWD] += 1
    return hbuf, cs, ga, h_t


def lstm_seq_fwd_kernel(x16, wx16, wh16, b, c0, h0, lengths):
    """The forward kernel; same contract as :func:`lstm_seq_fwd_plain`
    (hs is slots 1..T of the kernel's bf16 h buffer)."""
    _check_shapes(x16, wx16, wh16, b, c0, h0, lengths)
    hbuf, cs, ga, h_t = _fwd_launch(x16, wx16, wh16, b, c0, h0, lengths)
    return hbuf[1:x16.shape[0] + 1], cs, ga, h_t


def lstm_seq_bwd_kernel(saved: Saved, dhs, dct, dht, h_prev=None):
    """The backward kernel; same contract as :func:`lstm_seq_bwd_plain`.
    ``h_prev`` [T, N, H] bf16 is [bf16(h0); hs[0 .. T-2]], slots 0..T-1 of
    the forward kernel's h buffer; where None it is built here (a copy)."""
    x16, wx16, wh16, b, c0, h0, lengths, hs, cs, ga = saved
    T, N, E = x16.shape
    H = c0.shape[1]
    dev = x16.device
    dhs16 = dhs.to(torch.bfloat16).contiguous()
    dct = dct.float().contiguous()
    dht = dht.float().contiguous()
    if h_prev is None:
        h_prev = torch.cat([h0.to(torch.bfloat16)[None], hs[:-1]])
    _ext.require(dhs16.shape == (T, N, H) and dct.shape == dht.shape == (N, H)
                 and h_prev.shape == (T, N, H) and h_prev.is_contiguous()
                 and dhs16.device == dct.device == dht.device == dev,
                 "fused_lstm_seq: gradient shapes or devices disagree")
    plan = lstm_seq_plan(T, N, E, H, _ext.sm_count(dev.index))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((T, N, E), **f32)
    dc0 = torch.empty((N, H), **f32)
    dh0 = torch.empty((N, H), **f32)
    dwx = torch.empty((E, 4 * H), **f32)
    dwh = torch.empty((H, 4 * H), **f32)
    db = torch.empty((4 * H,), **f32)
    dg = torch.empty((T, N, 4 * H), dtype=torch.bfloat16, device=dev)
    dcbuf = torch.empty((N, H), **f32)
    db_part = torch.empty((plan.db_parts, 4 * H), **f32)
    w_part = torch.empty((plan.w_part_rows, 4 * H), **f32)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_lstm_seq_bwd(
            x16.data_ptr(), wx16.data_ptr(), wh16.data_ptr(),
            lengths.data_ptr(), c0.data_ptr(), h_prev.data_ptr(),
            cs.data_ptr(), ga.data_ptr(), dhs16.data_ptr(), dct.data_ptr(),
            dht.data_ptr(), dx.data_ptr(), dc0.data_ptr(), dh0.data_ptr(),
            dwx.data_ptr(), dwh.data_ptr(), db.data_ptr(), dg.data_ptr(),
            dcbuf.data_ptr(), db_part.data_ptr(), w_part.data_ptr(),
            T, N, E, H, plan.dx_wg, plan.dw_ct, plan.per_x, plan.per_h,
            _ext.stream_ptr(dev))
    _ext.check_launch(err, BWD)
    _ext.LAUNCHES[BWD] += 1
    return dx, dwx, dwh, db, dc0, dh0


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------

class _FusedLSTMSeq(torch.autograd.Function):
    """Inputs x [T,N,E], wx, wh, b, c0, h0 (any float type; cast here)
    and lengths; outputs (c_T, h_T, hs).  ``plain`` selects the plain
    versions on every device; otherwise CPU tensors take them and CUDA
    tensors the kernels."""

    @staticmethod
    def forward(ctx, x, wx, wh, b, c0, h0, lengths, plain: bool):
        bf16 = torch.bfloat16
        x16 = x.to(bf16).contiguous()
        wx16 = wx.to(bf16).contiguous()
        wh16 = wh.to(bf16).contiguous()
        bf = b.float().contiguous()
        c0f = c0.float().contiguous()
        h0f = h0.float().contiguous()
        args = (x16, wx16, wh16, bf, c0f, h0f, lengths)
        use_plain = plain or _ext.on_cpu(x16, wx16, wh16, bf, c0f, h0f,
                                         lengths)
        if use_plain:
            hs, cs, ga, h_t = lstm_seq_fwd_plain(*args)
            kept = hs
        else:
            # the kernels keep the bf16 h buffer: its slots 0..T-1 are the
            # backward's h_prev stack
            _check_shapes(*args)
            kept, cs, ga, h_t = _fwd_launch(*args)
            hs = kept[1:x16.shape[0] + 1]
        ctx.use_plain = use_plain
        ctx.dtypes = (x.dtype, wx.dtype, wh.dtype, b.dtype, c0.dtype, h0.dtype)
        ctx.save_for_backward(*args, kept, cs, ga)
        return cs[-1].clone(), h_t.clone(), hs

    @staticmethod
    def backward(ctx, dct, dht, dhs):
        *args, kept, cs, ga = ctx.saved_tensors
        if ctx.use_plain:
            grads = lstm_seq_bwd_plain((*args, kept, cs, ga), dhs, dct, dht)
        else:
            T = args[0].shape[0]
            grads = lstm_seq_bwd_kernel((*args, kept[1:T + 1], cs, ga), dhs,
                                        dct, dht, h_prev=kept[:T])
        dx, dwx, dwh, db, dc0, dh0 = (g.to(dt) for g, dt in zip(grads,
                                                                ctx.dtypes))
        return dx, dwx, dwh, db, dc0, dh0, None, None


def pad_lstm_seq(x, wx, wh, b, c0, h0, multiple: int = WIDTH_STEP) -> tuple:
    """(x, wx, wh, b, c0, h0) with E and H zero-padded up to multiples of
    ``multiple`` (every gate block of wx, wh and b to the padded H):
    the operands the kernels take at any width; differentiable."""
    E, H = x.shape[-1], c0.shape[1]
    Ep, Hp = round_up(E, multiple), round_up(H, multiple)
    return (pad_last(x, Ep), pad_gates(pad_first(wx, Ep), H, Hp),
            pad_gates(pad_first(wh, Hp), H, Hp), pad_gates(b, H, Hp),
            pad_last(c0, Hp), pad_last(h0, Hp))


def _run(x, wx, wh, b, c0, h0, lengths, plain: bool):
    _ext.require(lengths.dtype == torch.int32 and lengths.dim() == 1
                 and lengths.shape[0] == x.shape[1],
                 f"fused_lstm_seq: lengths must be int32 [{x.shape[1]}], got "
                 f"{lengths.dtype} {tuple(lengths.shape)}")
    H = c0.shape[1]
    padded = (not plain and (x.shape[-1] % WIDTH_STEP or H % WIDTH_STEP)
              and not _ext.on_cpu(x, wx, wh, b, c0, h0, lengths))
    if padded:
        x, wx, wh, b, c0, h0 = pad_lstm_seq(x, wx, wh, b, c0, h0)
    ct, ht, hs = _FusedLSTMSeq.apply(x, wx, wh, b, c0, h0,
                                     lengths.contiguous(), plain)
    if padded:
        ct, ht, hs = ct[:, :H], ht[:, :H], hs[..., :H]
    return (ct, ht), hs


def fused_lstm_seq(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                   b: torch.Tensor, c0: torch.Tensor, h0: torch.Tensor,
                   lengths: torch.Tensor
                   ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Masked teacher-forcing LSTM layer, differentiable.

    x [T,N,E] time-major, wx [E,4H], wh [H,4H], b [4H], c0/h0 [N,H],
    lengths [N] int32 (row n steps while t < lengths[n]) →
    ((c_T, h_T) f32, hs [T,N,H] bf16 with zeros at masked steps).  The
    gradients of x, wx, wh, b, c0 and h0 come back in their own types.
    CPU tensors take the plain versions; CUDA tensors launch the
    kernels (at E and H padded to multiples of 64) or raise."""
    return _run(x, wx, wh, b, c0, h0, lengths, plain=False)


def fused_lstm_seq_plain(x, wx, wh, b, c0, h0, lengths,
                         operands: torch.dtype = torch.bfloat16):
    """:func:`fused_lstm_seq` through the plain versions on any device:
    the CPU path, the test oracle and the card's comparison.  Under
    ``operands`` = f32 it is the f32 compute path's layer (the JAX
    package's f32 XLA scan): nothing rounded to bf16, hs f32, and the
    gradients by autograd of the forward."""
    if operands == torch.float32:
        hs, cs, _, h_t = lstm_seq_fwd_plain(
            x.float(), wx.float(), wh.float(), b, c0, h0,
            lengths.to(torch.int32), operands)
        return (cs[-1], h_t), hs
    return _run(x, wx, wh, b, c0, h0, lengths, plain=True)
