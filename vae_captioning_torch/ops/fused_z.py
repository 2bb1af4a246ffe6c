"""Fused z sampling + projection for the train path: CUDA kernel
wrappers, their plain versions and the autograd Function around them.

Counterpart of ``vae_captioning_tpu/ops/fused_z.py``.  The train step
draws K_z = ``gen_z_samples`` reparameterised samples per caption row and
feeds them to the decoder only through the ``z_rnn`` projection:

    out = bf16(Σ_s (μ + σ·eps_s) @ W_s) + bf16(b)       [N, E] bf16

with each sample tile rounded to bf16 once and the products accumulated
in f32, as the TPU kernel's ``_publish`` has it.  W is the ``nn.Linear``
weight [E, K_z·L] (the Flax kernel transposed); W_s is its column block
of sample s.  The backward regenerates eps:

    dμ = Σ_s dz @ W_sᵀ,  dσ = Σ_s eps_s ⊙ (dz @ W_sᵀ),
    dW_s = bf16(μ + σ·eps_s)ᵀ @ dz   (dz in bf16),  db = Σ_n dz (f32).

The noise is a counter-based Philox-4x32-10 keyed on (seed, step) that
counts on each element's logical index (row n, sample s, latent column
l), so the stream does not depend on tiling: :func:`philox_normals` in
plain integer ops gives the kernels' bits exactly, and rows [a:b] of a
draw equal the draw of those rows alone.  Bits to normal as on the TPU:
a 23-bit uniform clipped to [1e-7, 1 - 1e-7], then √2·erfinv(2u − 1).

On CUDA tensors :func:`fused_z` launches ``csrc/fused_z.cu`` and nothing
of size [N, K_z·L] reaches memory; on CPU tensors it takes the plain
versions, which also accept an explicit ``eps`` (the tests feed both
sides the same numbers).  What the kernels take besides the operands,
the column width, W's row pitch and the splits of the sample axis, and
the sizes of their workspaces are :func:`z_plan`'s, so the CPU tests
check them.  The kernels take E in multiples of 64: at other widths
:func:`fused_z` zero-pads W's rows and b (:func:`pad_z`; the noise does
not depend on E) and slices the output's columns back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import functools
import math
from typing import NamedTuple

import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.ops.padding import pad_first, round_up

FWD = "fused_z_fwd"
BWD = "fused_z_bwd"
EPS = "fused_z_eps"
_ROWS = 128               # rows of a forward or dμ/dσ block
_BOX = 64                 # latent columns of a box
_WIDTHS = (256, 192, 128, 64)   # column widths the kernels are built for
WIDTH_STEP = 64           # the kernels' E comes in multiples of this
_SMS = 132                # the H100's SMs, for plans made without a card
_EPS_LATENT_MAX = 14528   # the eps kernel's widest row: four in shared memory
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_ROOT2 = 1.4142135623730951


# ----------------------------------------------------------------------
# the generator, in plain integer ops
# ----------------------------------------------------------------------

def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a·m for int64 tensors a < 2^32 and a
    32-bit constant m, without an int64 overflow: m is split in halves
    of 16 bits, so every partial product stays below 2^49."""
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    mid = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(counter: Tuple[torch.Tensor, ...], seed: int, step: int
               ) -> Tuple[torch.Tensor, ...]:
    """Philox-4x32-10 of four int64 counter words (each < 2^32) under the
    key (seed, step): the four 32-bit output words, as int64."""
    c0, c1, c2, c3 = counter
    k0, k1 = seed & _MASK32, step & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) → N(0, 1) draws in f32, the TPU transform."""
    u = (bits >> 9).to(torch.float32) / 8388608.0
    lo = torch.tensor(1e-7, dtype=torch.float32)
    hi = torch.tensor(1.0 - 1e-7, dtype=torch.float32)
    u = torch.minimum(torch.maximum(u, lo.to(u.device)), hi.to(u.device))
    return _ROOT2 * torch.special.erfinv(2.0 * u - 1.0)


def philox_bits(seed: int, step: int, n_rows: int, n_samples: int,
                latent: int, row0: int = 0,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """The 32-bit words (int64) behind the eps of rows [row0, row0 +
    n_rows): [n_rows, n_samples, latent].  Element (n, s, l) is word
    l % 4 of the Philox block with counter (l // 4, s, n, 0)."""
    groups = -(-latent // 4)
    i64 = dict(dtype=torch.int64, device=device)
    q = torch.arange(groups, **i64).view(1, 1, groups)
    s = torch.arange(n_samples, **i64).view(1, n_samples, 1)
    n = torch.arange(row0, row0 + n_rows, **i64).view(n_rows, 1, 1)
    shape = (n_rows, n_samples, groups)
    words = philox4x32((q.expand(shape), s.expand(shape), n.expand(shape),
                        torch.zeros(shape, **i64)), seed, step)
    bits = torch.stack(words, dim=-1).reshape(n_rows, n_samples, 4 * groups)
    return bits[..., :latent]


def philox_normals(seed: int, step: int, n_rows: int, n_samples: int,
                   latent: int, row0: int = 0,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernels' eps for rows [row0, row0 + n_rows): [n_rows,
    n_samples, latent] f32, the normals of :func:`philox_bits`."""
    return bits_to_normal(philox_bits(seed, step, n_rows, n_samples, latent,
                                      row0, device))


def _check_seed(seed: int, step: int) -> None:
    _ext.require(0 <= seed <= _MASK32 and 0 <= step <= _MASK32,
                 f"fused_z: seed {seed} and step {step} must be 32-bit "
                 "unsigned integers")


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def _samples16(mean, std, eps, operands: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    """bf16(μ + σ·eps) as f32, [N, K, L] (unrounded under f32
    ``operands``)."""
    return (mean[:, None, :] + std[:, None, :] * eps).to(operands).float()


def z_fwd_plain(mean, std, w16, b, n_samples: int, eps,
                operands: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The forward kernel's maths: eps [N, K, L] → [N, E] bf16; under
    f32 ``operands`` (the f32 compute path) nothing is rounded and the
    result is f32."""
    N = mean.shape[0]
    z16 = _samples16(mean.float(), std.float(), eps, operands).reshape(N, -1)
    acc = z16 @ w16.to(operands).float().t()
    return acc.to(operands) + b.to(operands)


def z_bwd_plain(mean, std, w16, n_samples: int, eps, g
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's maths: → (dμ, dσ [N, L], dW [E, K·L]) f32."""
    N, L = mean.shape
    E = w16.shape[0]
    dz16 = g.to(torch.bfloat16).float()
    w3 = w16.float().reshape(E, n_samples, L)
    t = torch.einsum("ne,ekl->nkl", dz16, w3)
    z16 = _samples16(mean.float(), std.float(), eps)
    dw = torch.einsum("nkl,ne->ekl", z16, dz16).reshape(E, n_samples * L)
    return t.sum(dim=1), (t * eps).sum(dim=1), dw


# ----------------------------------------------------------------------
# kernel launches
# ----------------------------------------------------------------------

def _check(mean, std, w16, b, n_samples) -> Tuple[int, int, int]:
    req = _ext.require
    N, L = mean.shape
    E = w16.shape[0]
    req(mean.dtype == std.dtype == b.dtype == torch.float32
        and w16.dtype == torch.bfloat16,
        "fused_z: mean, std and b must be float32 and w bfloat16")
    req(std.shape == (N, L) and w16.shape == (E, n_samples * L)
        and b.shape == (E,),
        f"fused_z: shapes mean{tuple(mean.shape)} std{tuple(std.shape)} "
        f"w{tuple(w16.shape)} b{tuple(b.shape)} disagree with "
        f"n_samples={n_samples}")
    req(E % 64 == 0, f"fused_z: E={E} must be a multiple of 64")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in (mean, std, w16, b)),
        "fused_z: inputs must be contiguous and 16-byte aligned")
    return N, L, E


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ZPlan(NamedTuple):
    """What the kernels take besides the operands, and the shapes of
    their workspaces (f32)."""
    ct: int            # columns of E a block takes (E in E / ct chunks)
    pitch: int         # W's row pitch in elements: K·L rounded up to 8
    classes: int       # samples s, s + classes start at the same column mod 8
    boxes: int         # 64-column boxes of W a sample spans from there
    fwd_per: int       # forward (sample, box) steps a split
    fwd_splits: int
    bwd_per: int       # dμ/dσ samples of a class a split
    bwd_splits: int
    fwd_part: Tuple[int, int, int]       # [fwd_splits, rows, E]
    bwd_part: Tuple[int, int, int, int]  # [2, E / ct · classes · bwd_splits, rows, 64 boxes]


@functools.lru_cache(maxsize=None)
def z_plan(N: int, K: int, L: int, E: int, sms: int = _SMS) -> ZPlan:
    """The kernels' plan at (N, K_z, L, E) on ``sms`` SMs.

    ct is the widest of 256, 192, 128 and 64 that divides E, so at E ≤
    256 one block column covers E and the forward draws each normal once.
    TMA reads W in boxes that start on 16 bytes, so sample s's columns
    are read from s·L − d, d = s·L mod 8 (at most 8 − gcd(L, 8)), in
    ``boxes`` 64-column boxes; d repeats every ``classes`` = 8 / gcd(L, 8)
    samples.  The forward's K·boxes (sample, box) steps of each (128-row
    block, column chunk) are split, and the dμ/dσ kernel's samples of
    each (row block, box, column chunk, class), into as many ranges as
    fill the SMs in one wave (at least one each)."""
    ct = next(w for w in _WIDTHS if E % w == 0)
    g = math.gcd(L, 8)
    classes = 8 // g
    boxes = _cdiv(L + 8 - g, _BOX)
    row_blocks = _cdiv(N, _ROWS)
    chunks = E // ct
    steps = K * boxes
    fwd_per = _cdiv(steps, max(1, min(steps, sms // (row_blocks * chunks))))
    per_class = _cdiv(K, classes)
    bwd_units = row_blocks * boxes * chunks * classes
    bwd_per = _cdiv(per_class, max(1, min(per_class, sms // bwd_units)))
    fwd_splits, bwd_splits = _cdiv(steps, fwd_per), _cdiv(per_class, bwd_per)
    rows = row_blocks * _ROWS
    return ZPlan(ct=ct, pitch=_cdiv(K * L, 8) * 8, classes=classes, boxes=boxes,
                 fwd_per=fwd_per, fwd_splits=fwd_splits, bwd_per=bwd_per,
                 bwd_splits=bwd_splits, fwd_part=(fwd_splits, rows, E),
                 bwd_part=(2, chunks * classes * bwd_splits, rows, boxes * _BOX))


def _pitched(w16: torch.Tensor, pitch: int) -> torch.Tensor:
    """W as TMA reads it: itself where K·L is a multiple of 8 (its rows
    then start on 16-byte boundaries), else a copy with rows padded to
    ``pitch`` elements."""
    if w16.shape[1] == pitch:
        return w16
    out = torch.zeros((w16.shape[0], pitch), dtype=w16.dtype, device=w16.device)
    out[:, :w16.shape[1]] = w16
    return out


def z_fwd_kernel(mean, std, w16, b, n_samples: int, seed: int, step: int
                 ) -> torch.Tensor:
    """The forward kernel: → [N, E] bf16."""
    N, L, E = _check(mean, std, w16, b, n_samples)
    dev = mean.device
    plan = z_plan(N, n_samples, L, E, _ext.sm_count(dev.index))
    w = _pitched(w16, plan.pitch)
    part = torch.empty(plan.fwd_part, dtype=torch.float32, device=dev)
    out = torch.empty((N, E), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_z_fwd(
            mean.data_ptr(), std.data_ptr(), w.data_ptr(), b.data_ptr(),
            part.data_ptr(), out.data_ptr(), N, L, E, n_samples, plan.pitch,
            plan.ct, plan.classes, plan.boxes, plan.fwd_per, seed, step,
            _ext.stream_ptr(dev))
    _ext.check_launch(err, FWD)
    _ext.LAUNCHES[FWD] += 1
    return out


def z_bwd_kernel(mean, std, w16, n_samples: int, seed: int, step: int, g
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: → (dμ, dσ, dW) f32."""
    N, L = mean.shape
    E = w16.shape[0]
    dz16 = g.to(torch.bfloat16).contiguous()
    _ext.require(dz16.shape == (N, E) and dz16.device == mean.device,
                 f"fused_z: gradient shape {tuple(dz16.shape)} != {(N, E)}")
    dev = mean.device
    plan = z_plan(N, n_samples, L, E, _ext.sm_count(dev.index))
    w = _pitched(w16, plan.pitch)
    f32 = dict(dtype=torch.float32, device=dev)
    dmu = torch.empty((N, L), **f32)
    dsg = torch.empty((N, L), **f32)
    dw = torch.empty((E, n_samples * L), **f32)
    part = torch.empty(plan.bwd_part, **f32)
    with torch.cuda.device(dev):
        err = _ext.library().vct_fused_z_bwd(
            mean.data_ptr(), std.data_ptr(), w.data_ptr(), dz16.data_ptr(),
            dmu.data_ptr(), dsg.data_ptr(), dw.data_ptr(), part.data_ptr(), N, L,
            E, n_samples, plan.pitch, plan.ct, plan.classes, plan.boxes,
            plan.bwd_per, seed, step, _ext.stream_ptr(dev))
    _ext.check_launch(err, BWD)
    _ext.LAUNCHES[BWD] += 1
    return dmu, dsg, dw


def fused_z_eps(seed: int, step: int, n_rows: int, n_samples: int,
                latent: int, device: torch.device | str = "cpu",
                bits: bool = False) -> torch.Tensor:
    """The kernels' eps stream materialised, [n_rows, n_samples, latent]
    f32, for checks; with ``bits`` the 32-bit words instead (int64).  On
    a CUDA device through the eps kernel, on the CPU through
    :func:`philox_normals` / :func:`philox_bits`."""
    _check_seed(seed, step)
    device = torch.device(device)
    if device.type == "cpu":
        fn = philox_bits if bits else philox_normals
        return fn(seed, step, n_rows, n_samples, latent)
    _ext.require(device.type == "cuda", f"fused_z_eps: device {device}")
    _ext.require(n_rows * n_samples < 2 ** 31 and latent <= _EPS_LATENT_MAX,
                 f"fused_z_eps: [{n_rows}, {n_samples}, {latent}] past the "
                 f"kernel's {2 ** 31} rows or {_EPS_LATENT_MAX} latent columns")
    out = torch.empty((n_rows, n_samples, latent),
                      dtype=torch.int32 if bits else torch.float32,
                      device=device)
    with torch.cuda.device(device):
        err = _ext.library().vct_fused_z_eps(
            out.data_ptr(), n_rows, latent, n_samples, seed, step, int(bits),
            _ext.sm_count(out.device.index), _ext.stream_ptr(device))
    _ext.check_launch(err, EPS)
    _ext.LAUNCHES[EPS] += 1
    return out.long() & _MASK32 if bits else out


def transform_mismatches(device: torch.device | str) -> int:
    """On a CUDA device: how many of the 2^23 uniforms the draws can give
    map to a normal whose bits differ between the fused kernels'
    transform and ``erfinvf`` (the eps kernel's); 0 is right."""
    device = torch.device(device)
    _ext.require(device.type == "cuda", f"transform_mismatches: device {device}")
    count = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = _ext.library().vct_fused_z_transform_check(
            count.data_ptr(), _ext.stream_ptr(device))
    _ext.check_launch(err, "fused_z transform check")
    return int(count.item())


# ----------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------

class _FusedZ(torch.autograd.Function):
    """Inputs mean, std [N, L], w [E, K·L], b [E]; output [N, E] bf16.
    With ``eps`` given, or on CPU tensors, or with ``plain``, the plain
    versions run; otherwise the kernels."""

    @staticmethod
    def forward(ctx, mean, std, w, b, n_samples: int, seed: int, step: int,
                eps: Optional[torch.Tensor], plain: bool):
        meanf = mean.float().contiguous()
        stdf = std.float().contiguous()
        w16 = w.to(torch.bfloat16).contiguous()
        bf = b.float().contiguous()
        use_plain = (plain or eps is not None
                     or _ext.on_cpu(meanf, stdf, w16, bf))
        if use_plain:
            if eps is None:
                eps = philox_normals(seed, step, meanf.shape[0], n_samples,
                                     meanf.shape[1], device=meanf.device)
            out = z_fwd_plain(meanf, stdf, w16, bf, n_samples, eps.float())
        else:
            out = z_fwd_kernel(meanf, stdf, w16, bf, n_samples, seed, step)
            eps = None
        ctx.use_plain = use_plain
        ctx.args = (n_samples, seed, step)
        ctx.dtypes = (mean.dtype, std.dtype, w.dtype, b.dtype)
        ctx.save_for_backward(meanf, stdf, w16,
                              eps.float() if eps is not None else None)
        return out

    @staticmethod
    def backward(ctx, g):
        meanf, stdf, w16, eps = ctx.saved_tensors
        n_samples, seed, step = ctx.args
        if ctx.use_plain:
            dmu, dsg, dw = z_bwd_plain(meanf, stdf, w16, n_samples, eps, g)
        else:
            dmu, dsg, dw = z_bwd_kernel(meanf, stdf, w16, n_samples, seed,
                                        step, g)
        db = g.float().sum(dim=0)
        grads = (dmu, dsg, dw, db)
        return (*(x.to(dt) for x, dt in zip(grads, ctx.dtypes)),
                None, None, None, None, None)


def pad_z(w: torch.Tensor, b: torch.Tensor, multiple: int = WIDTH_STEP
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w [E, K·L], b [E]) with E zero-padded up to a multiple of
    ``multiple``; differentiable."""
    Ep = round_up(w.shape[0], multiple)
    return pad_first(w, Ep), pad_first(b, Ep)


def fused_z(mean: torch.Tensor, std: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor, n_samples: int, seed: int, step: int
            ) -> torch.Tensor:
    """``z_rnn`` of n_samples reparameterised draws N(mean, std²),
    differentiable, without storing the draws.

    mean/std [N, L], w [E, n_samples·L] (the ``nn.Linear`` weight), b
    [E]; seed and step are 32-bit unsigned keys of the noise.  Returns
    [N, E] bf16.  CPU tensors take the plain versions; CUDA tensors
    launch the kernels (at E padded to a multiple of 64) or raise."""
    _check_seed(seed, step)
    E = w.shape[0]
    if E % WIDTH_STEP and not _ext.on_cpu(mean, std, w, b):
        w, b = pad_z(w, b)
        return _FusedZ.apply(mean, std, w, b, n_samples, seed, step, None,
                             False)[:, :E]
    return _FusedZ.apply(mean, std, w, b, n_samples, seed, step, None, False)


def fused_z_plain(mean, std, w, b, n_samples: int, seed: int = 0,
                  step: int = 0, eps: Optional[torch.Tensor] = None,
                  operands: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`fused_z` through the plain versions on any device, with
    the noise from (seed, step) or from an explicit ``eps`` [N, K, L].
    Under ``operands`` = f32 it is the f32 compute path's z (the JAX
    package's f32 XLA sampling and projection): nothing rounded to bf16,
    an f32 result, the gradients by autograd of the forward."""
    _check_seed(seed, step)
    if eps is not None:
        _ext.require(eps.shape == (mean.shape[0], n_samples, mean.shape[1]),
                     f"fused_z: eps shape {tuple(eps.shape)}")
    if operands == torch.float32:
        if eps is None:
            eps = philox_normals(seed, step, mean.shape[0], n_samples,
                                 mean.shape[1], device=mean.device)
        return z_fwd_plain(mean, std, w, b, n_samples, eps.float(), operands)
    return _FusedZ.apply(mean, std, w, b, n_samples, seed, step, eps, True)
