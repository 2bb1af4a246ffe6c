"""Fused logits product + exact top-k + logsumexp, its int8 variant and
fused Gumbel-max sampling: CUDA kernel wrappers and their plain versions.

Counterparts of ``fused_logits_top_k``, ``fused_logits_top_k_int8`` (with
``quantize_logits_weights`` and ``_quantize_rows``) and
``fused_logits_sample`` in ``vae_captioning_tpu/ops/fused_logits_topk.py``.
For decode hidden states h the top-k functions return the k largest raw
logits of ``h @ W + b`` (bias included), their vocab indices with ties
going to the lowest index, and the logsumexp over the whole vocab.  Beam
search normalises only the k winners; greedy decoding takes k = 1.  The
int8 variant quantises h per row and W per column (symmetric, round half
to even) and dequantises the int32 product as ``acc·hs·ws + b``; it is
approximate by design.  The sampler draws one token per row from
``softmax(logits / T)`` as ``argmax(logits·(1/T) + G)`` with Gumbel noise
G from a Philox stream keyed on (seed, step) that counts on the element's
(row, vocab column); :func:`fused_logits_sample_plain` gives the same
bits in integer ops.

On CUDA tensors the wrappers launch ``csrc/fused_logits_topk.cu`` (a
wgmma + TMA partial kernel over vocab chunks, then a merge launch), which
never stores the [M, V] logits; on CPU tensors they take the plain
versions.  The kernels' lists hold at most ``K_MAX`` = 16 entries: for a
wider k (beams of 17 and more) the top-k wrappers launch the writer, the
same product with no fold, which stores the f32 logits (bf16: acc + b;
int8 bit for bit as :func:`int8_logits`), counted as the wrapper's
launch, and take the top-k + logsumexp kernel over them
(``ops/topk_lse.py``), which counts its own.  The writer stages its tiles
in shared memory and stores them by TMA, whose tensor maps need 16-byte
rows: it writes into rows of :func:`logits_pitch` floats and hands over
the ``[M, V]`` view (:func:`pitched_logits`), which the top-k kernel
reads at that pitch.  The kernels read the head transposed, W^T [V, H]
contiguous: the decode stores it so (``w.t().contiguous().t()``, once per
build), and the wrappers pass ``w.t().contiguous()``, which copies
nothing for that layout and transposes any other.  The bf16 kernels take H in multiples
of 32 and the int8 kernel in multiples of 64: at other widths the
wrappers zero-pad h's columns and W^T's (:func:`pad_logits`, once a
call; exact, the added terms are 0·0, and zeros leave int8's per-row
scale as it is).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from vae_captioning_torch import _ext
from vae_captioning_torch.ops.fused_z import philox4x32
from vae_captioning_torch.ops.padding import pad_last, round_up
from vae_captioning_torch.ops.topk_lse import stable_top_k, top_k_logsumexp

NAME = "fused_logits_top_k"
INT8 = "fused_logits_top_k_int8"
SAMPLE = "fused_logits_sample"
SAMPLE_TAG = 0x53414D50  # last counter word of the sampler's stream
_MASK32 = 0xFFFFFFFF
K_MAX = 16               # the fused kernels' longest list
_TV = 128                # vocab columns of a tile
_LIST_K = (1, 3, 10, 16)  # the kernels' list lengths: k rounded up
_WORKSPACE = 64 << 20    # the partials' bytes a plan may take
WIDTH_STEP = 32          # the bf16 kernels' H comes in multiples of this
INT8_WIDTH_STEP = 64     # the int8 kernel's

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def bf16_logits(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                reverse_sum: bool = False) -> torch.Tensor:
    """The kernel's logits [M, V] f32 in plain PyTorch: bf16-rounded
    operands upcast to f32, an f32 matmul plus the f32 bias.
    ``reverse_sum`` sums each dot product in reverse order, the same
    maths rounded another way."""
    hf = h.to(torch.bfloat16).float()
    wf = w.to(torch.bfloat16).float()
    if reverse_sum:
        hf, wf = hf.flip(-1), wf.flip(0)
    return hf @ wf + b.float()


def fused_logits_top_k_plain(h: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, k: int,
                             reverse_sum: bool = False,
                             plan_rows: Optional[int] = None) -> Result:
    """The kernel's maths in plain PyTorch: :func:`bf16_logits`, a stable
    sort.  ``plan_rows`` is the wrapper's and changes nothing here: the
    plain version sums a row in one order whatever the rows."""
    logits = bf16_logits(h, w, b, reverse_sum)
    vals, idx = stable_top_k(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=-1)


class LogitsPlan(NamedTuple):
    """The partial kernel's launch for (M, H, V, k): block (x, y) of the
    grid takes rows [x·rows, (x + 1)·rows) and the vocab tiles [y·
    chunk_tiles, (y + 1)·chunk_tiles), and writes ``parts // chunks``
    partial lists of ``list_k`` per row (one per warpgroup that holds
    the row's columns); the merge launch folds the ``parts`` partials of
    a row in order."""

    rows: int           # 128 (a warpgroup's rows each) or 64 (columns split)
    resident: bool      # h kept in shared memory, else streamed beside W
    chunk_tiles: int
    chunks: int
    list_k: int         # k rounded up to 1, 3, 10 or 16
    parts: int          # P = chunks · (2 if rows == 64 else 1)


@functools.lru_cache(maxsize=None)
def block_shape(H: int, elem_bytes: int, k: int, rows: int = 0) -> Tuple[int, bool]:
    """(rows, resident) of the kernels' blocks at width H (bf16:
    elem_bytes 2; int8: 1) for lists of k, as ``csrc/fused_logits_topk.cu``
    chooses it from ``csrc/row_ring.cuh``'s shared-memory layout: 128 rows
    resident where they fit beside a ring of four W boxes and the lists
    hold at most 10, else 64 rows, resident beside four boxes or streamed.
    ``rows`` forces 128 or 64 where it fits (ValueError where not).
    Builds and asks the kernels' library."""
    code = _ext.library().vct_fused_logits_top_k_block(H, int(elem_bytes == 1), k, rows)
    if code < 0:
        raise ValueError(f"logits_plan: rows={rows} does not fit H={H}, k={k}")
    return code // 2, bool(code % 2)


@functools.lru_cache(maxsize=None)
def chunk_plan(M: int, V: int, k: int, rows: int = 128, resident: bool = True,
               sms: int = 132) -> LogitsPlan:
    """The vocab chunks for blocks of ``rows`` rows: the count that takes
    the fewest tile slots per SM, waves x (tiles a block + half a tile for
    its h load and epilogue), as ``ops/fused_ce.py:ce_fwd_plan`` counts
    them, among the counts whose partials fit in ``_WORKSPACE`` bytes (the
    fewest on a tie); no chunk is empty.  At M = 1536, V = 11500 in
    128-row blocks: 10 chunks of 9 of the 90 tiles, 120 blocks."""
    list_k = next(K for K in _LIST_K if K >= k)
    m_blocks, v_tiles = -(-M // rows), -(-V // _TV)
    per_chunk = (2 if rows == 64 else 1) * M * (8 * list_k + 8)
    most = max(1, min(v_tiles, _WORKSPACE // per_chunk))
    best = None
    for chunks in range(1, most + 1):
        per = -(-v_tiles // chunks)
        if -(-v_tiles // per) != chunks:
            continue                    # the same split as fewer chunks
        cost = -(-m_blocks * chunks // sms) * (2 * per + 1)
        if best is None or cost < best[0]:
            best = (cost, chunks, per)
    _, chunks, per = best
    return LogitsPlan(rows=rows, resident=resident, chunk_tiles=per,
                      chunks=chunks, list_k=list_k,
                      parts=chunks * (2 if rows == 64 else 1))


def logits_plan(M: int, H: int, V: int, k: int, elem_bytes: int = 2,
                sms: int = 132, rows: int = 0) -> LogitsPlan:
    """The kernels' launch: :func:`block_shape`'s blocks and
    :func:`chunk_plan`'s chunks for them."""
    return chunk_plan(M, V, k, *block_shape(H, elem_bytes, k, rows), sms)


def _workspace(plan: LogitsPlan, M: int, dev) -> Tuple[int, ...]:
    """One f32 buffer for the partials: (buffer, then the pointers of
    part_vals [P, M, K], part_idx [P, M, K] int32, part_max, part_sum [P,
    M]); returns the buffer first so that it lives through the call."""
    n = plan.parts * M
    buf = torch.empty((n * (2 * plan.list_k + 2),), dtype=torch.float32,
                      device=dev)
    p = buf.data_ptr()
    K = plan.list_k
    return buf, p, p + 4 * n * K, p + 8 * n * K, p + 4 * n * (2 * K + 1)


def _plan_args(plan: LogitsPlan) -> tuple:
    return plan.rows, int(plan.resident), plan.chunk_tiles, plan.chunks


def logits_pitch(V: int) -> int:
    """The written logits' row pitch in floats: V rounded up to 4, the
    16-byte rows a TMA tensor map needs."""
    return round_up(V, 4)


def pitched_logits(M: int, V: int, device) -> torch.Tensor:
    """The [M, V] f32 view of an uninitialised [M, logits_pitch(V)]
    buffer, the writer's output (its columns past V are never written)."""
    return torch.empty((M, logits_pitch(V)), dtype=torch.float32,
                       device=device)[:, :V]


def _write_logits(name: str, M: int, H: int, V: int, elem_bytes: int,
                  dev, ptrs: tuple, plan: LogitsPlan = None) -> torch.Tensor:
    """The kernel's logits [M, V] f32, stored by its writer
    (``vct_fused_logits_write``, or ``_int8`` where ``elem_bytes`` is 1)
    over the operands' pointers ``ptrs`` into :func:`pitched_logits`;
    ``plan`` defaults to :func:`logits_plan`'s for lists of one."""
    logits = pitched_logits(M, V, dev)
    if M:
        plan = plan or logits_plan(M, H, V, 1, elem_bytes,
                                   _ext.sm_count(dev.index or 0))
        lib = _ext.library()
        fn = lib.vct_fused_logits_write_int8 if elem_bytes == 1 \
            else lib.vct_fused_logits_write
        with _ext.device_scope(dev):
            err = fn(*ptrs, logits.data_ptr(), M, H, V, logits_pitch(V),
                     *_plan_args(plan), _ext.stream_ptr(dev))
        _ext.check_launch(err, name)
        _ext.LAUNCHES[name] += 1
    return logits


def fused_logits_top_k(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       k: int, plan_rows: Optional[int] = None) -> Result:
    """h [M,H] bf16, w [H,V] bf16 (any layout; the kernel reads ``w.t()``
    contiguous, as the decode stores it), b [V] f32 → (values [M,k] f32,
    indices [M,k] int32, logsumexp [M] f32), 1 <= k <= V.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (at H padded to
    a multiple of 32; past K_MAX, the logits written and the top-k +
    logsumexp kernel) or raise.  No
    backward: raises RuntimeError when grad mode is on and an input
    requires grad.  ``plan_rows`` (default M) is the row count whose
    launch plan the kernel takes: the plan splits the vocabulary into
    chunks by the row count, and a row's logsumexp sums its chunks in
    that split, so a share of a batch given the whole batch's count
    returns each row bit for bit as the whole batch does."""
    _ext.forbid_grad(NAME, h, w, b)
    if _ext.on_cpu(h, w, b):
        return fused_logits_top_k_plain(h, w, b, k)
    _ext.require(h.dim() == w.dim() == 2,
                 f"{NAME}: h{tuple(h.shape)} and w{tuple(w.shape)} must be 2-D")
    h, w_t = pad_logits(h, w.t().contiguous())
    return logits_top_k_kernel(h, w_t, b, k,
                               _rows_plan(plan_rows, h, w_t.shape[0], k, 2))


def _rows_plan(plan_rows: Optional[int], h: torch.Tensor, V: int, k: int,
               elem_bytes: int) -> Optional[LogitsPlan]:
    """The plan of ``plan_rows`` rows for the top-k kernels on ``h``
    (None: the kernel's own, of h's rows)."""
    if plan_rows is None or plan_rows == h.shape[0]:
        return None
    return logits_plan(plan_rows, h.shape[1], V, k if k <= K_MAX else 1,
                       elem_bytes, _ext.sm_count(h.device.index or 0))


def pad_logits(h: torch.Tensor, w_t: torch.Tensor,
               multiple: int = WIDTH_STEP) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h [M, H], w_t [V, H]) with H zero-padded up to a multiple of
    ``multiple`` where both have H columns (else as they are, for the
    kernel's checks to reject)."""
    H = h.shape[-1]
    if H % multiple == 0 or h.dim() != 2 or w_t.shape[-1] != H:
        return h, w_t
    Hp = round_up(H, multiple)
    return pad_last(h, Hp), pad_last(w_t, Hp)


def _check_bf16(name: str, h, w_t, b) -> Tuple[int, int, int]:
    M, H = h.shape
    V = w_t.shape[0]
    req = _ext.require
    req(h.dtype == w_t.dtype == torch.bfloat16 and b.dtype == torch.float32,
        f"{name}: h and w must be bfloat16 and b float32, got "
        f"{h.dtype}, {w_t.dtype}, {b.dtype}")
    req(w_t.shape[1] == H and b.shape == (V,),
        f"{name}: shapes h{tuple(h.shape)} w{tuple(w_t.t().shape)} "
        f"b{tuple(b.shape)} disagree")
    req(H % 32 == 0, f"{name}: H={H} must be a multiple of 32")
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (h, w_t, b)),
        f"{name}: inputs must be contiguous and 16-byte aligned")
    return M, H, V


def logits_top_k_kernel(h: torch.Tensor, w_t: torch.Tensor, b: torch.Tensor,
                        k: int, plan: LogitsPlan = None) -> Result:
    """The bf16 kernel on the head transposed: h [M,H] bf16, w_t [V,H]
    bf16 contiguous, b [V] f32, all on one CUDA device; ``plan`` defaults
    to :func:`logits_plan`'s.  Past K_MAX: the kernel writes the logits
    (with ``plan``, where given, as its launch), then ``top_k_logsumexp``."""
    M, H, V = _check_bf16(NAME, h, w_t, b)
    _ext.require(1 <= k <= V, f"{NAME}: k={k} outside [1, V={V}]")
    dev = h.device
    if k > K_MAX:
        return top_k_logsumexp(_write_logits(
            NAME, M, H, V, 2, dev,
            (h.data_ptr(), w_t.data_ptr(), b.data_ptr()), plan), k)
    vals = torch.empty((M, k), dtype=torch.float32, device=dev)
    idx = torch.empty((M, k), dtype=torch.int32, device=dev)
    lse = torch.empty((M,), dtype=torch.float32, device=dev)
    if M:
        plan = plan or logits_plan(M, H, V, k, 2, _ext.sm_count(dev.index or 0))
        with _ext.device_scope(dev):
            buf, *parts = _workspace(plan, M, dev)
            err = _ext.library().vct_fused_logits_top_k(
                h.data_ptr(), w_t.data_ptr(), b.data_ptr(), *parts,
                vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), M, H, V, k,
                *_plan_args(plan), _ext.stream_ptr(dev))
        _ext.check_launch(err, NAME)
        _ext.LAUNCHES[NAME] += 1
    return vals, idx, lse


def logits_kernel(h: torch.Tensor, w_t: torch.Tensor, b: torch.Tensor,
                  plan: LogitsPlan = None) -> torch.Tensor:
    """The bf16 kernel's logits written, [M, V] f32 (its accumulators plus
    b: :func:`bf16_logits` to sum order; the view of rows
    :func:`logits_pitch` floats apart), operands as
    :func:`logits_top_k_kernel`'s; what that function hands the top-k +
    logsumexp kernel past K_MAX."""
    M, H, V = _check_bf16(NAME, h, w_t, b)
    return _write_logits(NAME, M, H, V, 2, h.device,
                         (h.data_ptr(), w_t.data_ptr(), b.data_ptr()), plan)


# ----------------------------------------------------------------------
# int8 logits
# ----------------------------------------------------------------------

def quantize_logits_weights(w: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 quantisation of the logits head
    [H, V]: wq = round(w / ws) in [-127, 127], ws = max_i |w[i]| / 127
    (at least 1e-12).  Once per decode-fn build (``Config.decode_int8``).
    wq [H, V] is stored column-major (``wq.t()`` is contiguous), the
    layout the kernel reads."""
    w = w.float()
    ws = torch.clamp_min(w.abs().amax(dim=0) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / ws[None, :]), -127, 127)
    return wq.to(torch.int8).t().contiguous().t(), ws.contiguous()


def quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantisation of the activations
    [M, H]: (hq [M, H] int8, hs [M, 1] f32)."""
    h = h.float()
    hs = torch.clamp_min(h.abs().amax(dim=1, keepdim=True) / 127.0, 1e-12)
    hq = torch.clamp(torch.round(h / hs), -127, 127)
    return hq.to(torch.int8).contiguous(), hs


def int8_logits(hq: torch.Tensor, hs: torch.Tensor, wq: torch.Tensor,
                ws: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's logits [M, V] f32 in plain PyTorch: f32(hq @ wq)
    · hs · ws + b, each product rounded on its own (the integer product
    is exact in float64: |acc| <= 127² · H)."""
    acc = (hq.double() @ wq.double()).float()
    return acc * hs * ws[None, :] + b.float()[None, :]


def int8_top_k_plain(hq: torch.Tensor, hs: torch.Tensor, wq: torch.Tensor,
                     ws: torch.Tensor, b: torch.Tensor, k: int) -> Result:
    """The int8 kernel's maths on quantised rows in plain PyTorch:
    :func:`int8_logits`, a stable sort."""
    logits = int8_logits(hq, hs, wq, ws, b)
    vals, idx = stable_top_k(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=-1)


def fused_logits_top_k_int8_plain(h: torch.Tensor, wq: torch.Tensor,
                                  ws: torch.Tensor, b: torch.Tensor,
                                  k: int, plan_rows: Optional[int] = None
                                  ) -> Result:
    """:func:`fused_logits_top_k_int8` in plain PyTorch (the JAX
    package's ``fused_logits_top_k_int8_xla``): h quantised per row, then
    :func:`int8_top_k_plain`; ``plan_rows`` changes nothing here."""
    return int8_top_k_plain(*quantize_rows(h), wq, ws, b, k)


def fused_logits_top_k_int8(h: torch.Tensor, wq: torch.Tensor,
                            ws: torch.Tensor, b: torch.Tensor,
                            k: int, plan_rows: Optional[int] = None) -> Result:
    """h [M,H] float (quantised here, per row, by plain PyTorch ops, as
    the JAX package quantises outside its kernel), wq [H,V] int8 and ws
    [V] f32 from :func:`quantize_logits_weights`, b [V] f32 → (values
    [M,k] f32, indices [M,k] int32, logsumexp [M] f32), 1 <= k <= V.
    CPU tensors take the plain version; CUDA tensors launch the kernel (at
    H padded to a multiple of 64; past K_MAX, the logits written and the
    top-k + logsumexp kernel) or raise.  ``plan_rows`` as
    :func:`fused_logits_top_k` takes it."""
    _ext.forbid_grad(INT8, h, wq, ws, b)
    if _ext.on_cpu(h, wq, ws, b):
        return fused_logits_top_k_int8_plain(h, wq, ws, b, k)
    hq, hs = quantize_rows(h)
    hq, wq_t = pad_logits(hq, wq.t(), INT8_WIDTH_STEP)
    return int8_top_k_kernel(hq, hs, wq_t.t(), ws, b, k,
                             _rows_plan(plan_rows, hq, wq_t.shape[0], k, 1))


def int8_top_k_kernel(hq: torch.Tensor, hs: torch.Tensor, wq: torch.Tensor,
                      ws: torch.Tensor, b: torch.Tensor, k: int,
                      plan: LogitsPlan = None) -> Result:
    """The int8 kernel on quantised rows: hq [M,H] int8, hs [M,1] f32
    (from :func:`quantize_rows`), wq [H,V] int8, ws and b [V] f32, all on
    one CUDA device; ``plan`` defaults to :func:`logits_plan`'s.  The
    kernel reads wq column-major, as :func:`quantize_logits_weights`
    stores it; a row-major wq is transposed on each call.  Past K_MAX: the
    kernel writes the logits (bit for bit :func:`int8_logits`), then
    ``top_k_logsumexp``."""
    M, H, V, wq_t = _check_int8(hq, hs, wq, ws, b)
    _ext.require(1 <= k <= V, f"{INT8}: k={k} outside [1, V={V}]")
    dev = hq.device
    if k > K_MAX:
        return top_k_logsumexp(_write_logits(
            INT8, M, H, V, 1, dev, (hq.data_ptr(), hs.data_ptr(),
                                    wq_t.data_ptr(), ws.data_ptr(),
                                    b.data_ptr()), plan), k)
    vals = torch.empty((M, k), dtype=torch.float32, device=dev)
    idx = torch.empty((M, k), dtype=torch.int32, device=dev)
    lse = torch.empty((M,), dtype=torch.float32, device=dev)
    if M:
        plan = plan or logits_plan(M, H, V, k, 1, _ext.sm_count(dev.index or 0))
        with _ext.device_scope(dev):
            buf, *parts = _workspace(plan, M, dev)
            err = _ext.library().vct_fused_logits_top_k_int8(
                hq.data_ptr(), hs.data_ptr(), wq_t.data_ptr(), ws.data_ptr(),
                b.data_ptr(), *parts, vals.data_ptr(), idx.data_ptr(),
                lse.data_ptr(), M, H, V, k, *_plan_args(plan),
                _ext.stream_ptr(dev))
        _ext.check_launch(err, INT8)
        _ext.LAUNCHES[INT8] += 1
    return vals, idx, lse


def int8_logits_kernel(hq: torch.Tensor, hs: torch.Tensor, wq: torch.Tensor,
                       ws: torch.Tensor, b: torch.Tensor,
                       plan: LogitsPlan = None) -> torch.Tensor:
    """The int8 kernel's logits written, [M, V] f32 (a view, as
    :func:`logits_kernel`'s), bit for bit :func:`int8_logits`; operands
    as :func:`int8_top_k_kernel`'s."""
    M, H, V, wq_t = _check_int8(hq, hs, wq, ws, b)
    return _write_logits(INT8, M, H, V, 1, hq.device,
                         (hq.data_ptr(), hs.data_ptr(), wq_t.data_ptr(),
                          ws.data_ptr(), b.data_ptr()), plan)


def _check_int8(hq, hs, wq, ws, b) -> Tuple[int, int, int, torch.Tensor]:
    """(M, H, V, wq_t) of the int8 kernel's operands, checked; wq_t [V, H]
    contiguous (a no-op for the stored layout)."""
    M, H = hq.shape
    V = wq.shape[1]
    req = _ext.require
    req(hq.dtype == wq.dtype == torch.int8
        and hs.dtype == ws.dtype == b.dtype == torch.float32,
        f"{INT8}: hq and wq must be int8, hs, ws and b float32, got "
        f"{hq.dtype}, {wq.dtype}, {hs.dtype}, {ws.dtype}, {b.dtype}")
    req(wq.shape[0] == H and hs.numel() == M and ws.shape == b.shape == (V,),
        f"{INT8}: shapes hq{tuple(hq.shape)} hs{tuple(hs.shape)} "
        f"wq{tuple(wq.shape)} ws{tuple(ws.shape)} b{tuple(b.shape)} disagree")
    req(H % 64 == 0, f"{INT8}: H={H} must be a multiple of 64")
    wq_t = wq.t().contiguous()          # a no-op for the stored layout
    req(all(t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in (hq, hs, wq_t, ws, b)),
        f"{INT8}: inputs must be contiguous and 16-byte aligned")
    return M, H, V, wq_t


# ----------------------------------------------------------------------
# Gumbel-max sampling
# ----------------------------------------------------------------------

def _check_key(seed: int, step: int) -> None:
    _ext.require(0 <= seed <= _MASK32 and 0 <= step <= _MASK32,
                 f"{SAMPLE}: seed {seed} and step {step} must be 32-bit "
                 "unsigned integers")


def sample_bits(seed: int, step: int, n_rows: int, V: int, row0: int = 0,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """The sampler's 32-bit words (int64) for rows [row0, row0 + n_rows):
    [n_rows, V].  Element (m, v) is word v % 4 of the Philox block with
    counter (v // 4, m, 0, SAMPLE_TAG) under the key (seed, step)."""
    groups = -(-V // 4)
    i64 = dict(dtype=torch.int64, device=device)
    q = torch.arange(groups, **i64).view(1, groups)
    m = torch.arange(row0, row0 + n_rows, **i64).view(n_rows, 1)
    shape = (n_rows, groups)
    words = philox4x32((q.expand(shape), m.expand(shape),
                        torch.zeros(shape, **i64),
                        torch.full(shape, SAMPLE_TAG, **i64)), seed, step)
    return torch.stack(words, dim=-1).reshape(n_rows, 4 * groups)[:, :V]


def gumbel_noise(seed: int, step: int, n_rows: int, V: int, row0: int = 0,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """G = -log(-log(u)) [n_rows, V] f32 of :func:`sample_bits`, u the
    23-bit uniform clipped to [1e-7, 1 - 1e-7], as the TPU kernel makes it."""
    bits = sample_bits(seed, step, n_rows, V, row0, device)
    u = (bits >> 9).to(torch.float32) / 8388608.0
    lo = torch.tensor(1e-7, dtype=torch.float32, device=u.device)
    hi = torch.tensor(1.0 - 1e-7, dtype=torch.float32, device=u.device)
    u = torch.minimum(torch.maximum(u, lo), hi)
    return -torch.log(-torch.log(u))


def sample_scores(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  seed: int, step: int, temperature: float = 1.0,
                  row0: int = 0) -> torch.Tensor:
    """The sampler's scored values [M, V] f32: logits · f32(1/T) + G, the
    logits of :func:`bf16_logits`."""
    logits = bf16_logits(h, w, b)
    inv_temp = torch.tensor(1.0 / temperature, dtype=torch.float32,
                            device=logits.device)
    return logits * inv_temp + gumbel_noise(seed, step, h.shape[0],
                                            w.shape[1], row0, logits.device)


def fused_logits_sample_plain(h: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, seed: int, step: int,
                              temperature: float = 1.0,
                              row0: int = 0) -> torch.Tensor:
    """The sampler's maths in plain PyTorch: tokens [M] int32, the first
    argmax of :func:`sample_scores`."""
    _check_key(seed, step)
    return torch.argmax(sample_scores(h, w, b, seed, step, temperature, row0),
                        dim=-1).to(torch.int32)


def fused_logits_sample(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        seed: int, step: int, temperature: float = 1.0,
                        row0: int = 0) -> torch.Tensor:
    """One categorical draw per row from softmax((h @ w + b) / T): h
    [M,H] bf16, w [H,V] bf16 (any layout, as :func:`fused_logits_top_k`
    takes it), b [V] f32, seed and step 32-bit unsigned keys of the noise,
    row0 the first row's index in the stream → tokens [M] int32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (at H
    padded to a multiple of 32) or raise."""
    _ext.forbid_grad(SAMPLE, h, w, b)
    _check_key(seed, step)
    if _ext.on_cpu(h, w, b):
        return fused_logits_sample_plain(h, w, b, seed, step, temperature,
                                         row0)
    _ext.require(h.dim() == w.dim() == 2,
                 f"{SAMPLE}: h{tuple(h.shape)} and w{tuple(w.shape)} must be 2-D")
    return sample_kernel(*pad_logits(h, w.t().contiguous()), b, seed, step,
                         temperature, row0)


def sample_kernel(h: torch.Tensor, w_t: torch.Tensor, b: torch.Tensor,
                  seed: int, step: int, temperature: float = 1.0,
                  row0: int = 0, plan: LogitsPlan = None) -> torch.Tensor:
    """The sampler kernel on the head transposed (w_t [V,H] bf16
    contiguous), all on one CUDA device; ``plan`` defaults to
    :func:`logits_plan`'s for k = 1 in 64-row blocks (the kernel has no
    128-row instance: its Philox words beside 64 accumulators spilled)."""
    M, H, V = _check_bf16(SAMPLE, h, w_t, b)
    _check_key(seed, step)
    _ext.require(temperature > 0,
                 f"{SAMPLE}: temperature {temperature} must be > 0")
    dev = h.device
    vals = torch.empty((M,), dtype=torch.float32, device=dev)
    tokens = torch.empty((M,), dtype=torch.int32, device=dev)
    if M:
        plan = plan or logits_plan(M, H, V, 1, 2, _ext.sm_count(dev.index or 0),
                                   rows=64)
        with _ext.device_scope(dev):
            buf, part_vals, part_idx, _, _ = _workspace(plan, M, dev)
            err = _ext.library().vct_fused_logits_sample(
                h.data_ptr(), w_t.data_ptr(), b.data_ptr(), part_vals,
                part_idx, vals.data_ptr(), tokens.data_ptr(), M, H, V, seed,
                step, 1.0 / temperature, row0, *_plan_args(plan),
                _ext.stream_ptr(dev))
        _ext.check_launch(err, SAMPLE)
        _ext.LAUNCHES[SAMPLE] += 1
    return tokens
