"""The yardstick of the roofline and MFU readings: the chip's peaks and
the work each operation of a decode batch or a train step needs, reckoned
from the shapes by operation, whatever kernels compute it.

Each operation counts its products (2 x m x n x k a product) and its bytes:
each input read once and each output written once, in the types the
configuration states (bf16 operands, f32 state, accumulations and
optimizer), never the logits that a fused kernel need not write.  Where
the work depends on the data it counts what the inputs need: real tokens
(not the padded positions of a bucket), real images (not a batch's
padding rows), the decode steps that ran.  An operation's least time is
the larger of its products at the bf16 peak and its bytes at the memory
rate; a pass's bound is the sum over its operations.  Peaks: one NVIDIA
H100 SXM (data sheet, dense, 700 W).
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple

PEAK_BF16 = 989e12        # FLOP/s
PEAK_BYTES = 3.35e12      # B/s
BF16, F32, I32, I64 = 2, 4, 4, 8


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float

    def seconds(self) -> float:
        return max(self.flops / PEAK_BF16, self.bytes / PEAK_BYTES)


def bound_seconds(ops: Iterable[Op]) -> float:
    return sum(op.seconds() for op in ops)


def model_flops(ops: Iterable[Op]) -> float:
    return sum(op.flops for op in ops)


def scaled(ops: Iterable[Op], times: float) -> List[Op]:
    return [Op(o.name, o.flops * times, o.bytes * times) for o in ops]


def lstm_step(name: str, rows: int, E: int, H: int) -> Op:
    """One LSTM step over ``rows``: [x, h] @ W [E+H, 4H], x and W in bf16,
    c and h in f32 in and out."""
    return Op(name, 2.0 * rows * (E + H) * 4 * H,
              rows * E * BF16 + (E + H) * 4 * H * BF16 + 4 * H * F32
              + 4 * rows * H * F32)


def dense(name: str, rows: int, n_in: int, n_out: int, width: int) -> Op:
    """rows x n_in @ n_in x n_out with operands and output of ``width``."""
    return Op(name, 2.0 * rows * n_in * n_out,
              (rows * n_in + n_in * n_out + n_out + rows * n_out) * width)


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------

def decode_init(cfg: dict, images: int) -> List[Op]:
    """z from the prior and the three conditioning steps of ``images``."""
    E, H, L = cfg["embed_size"], cfg["decoder_hidden"], cfg["latent_size"]
    F, C = cfg["cnn_feature_size"], cfg["num_clusters"]
    return [dense("image embedding", images, F, E, F32),
            dense("cluster embedding", images, C, E, F32),
            Op("z prior", 2.0 * images * (C * L + L * E + E * E),
               images * (C + L + 2 * E) * F32),
            lstm_step("init steps", images, E, H),
            lstm_step("init steps", images, E, H),
            lstm_step("init steps", images, E, H)]


def decode_step(cfg: dict, images: int, beam: int) -> List[Op]:
    """One beam step of ``images`` x ``beam`` rows: the LSTM, the logits
    head folded into each row's top-``beam`` with its log-sum-exp (the
    [N, V] logits need not be written), the merge of beam^2 candidates and
    the carry's reorder."""
    E, H, V = cfg["embed_size"], cfg["decoder_hidden"], cfg["vocab_size"]
    N = images * beam
    return [lstm_step("lstm step", N, E, H),
            Op("head + top-k", 2.0 * N * H * V,
               N * H * BF16 + H * V * BF16 + V * F32
               + N * beam * (F32 + I32) + N * F32),
            Op("beam merge", 0.0,
               N * beam * (F32 + I32) + N * F32 + 4 * N * H * F32
               + 3 * N * I64)]


def decode_batch(cfg: dict, images: int, beam: int, steps: int) -> List[Op]:
    return decode_init(cfg, images) + scaled(decode_step(cfg, images, beam),
                                             steps)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

def train_step(cfg: dict, images: int, captions: int, tokens: int,
               params: int) -> List[Op]:
    """One train step of ``images`` x ``captions`` rows holding ``tokens``
    real tokens (labels != PAD) and ``params`` parameters: forward, the
    backward's products (dX and dW of each product whose input needs a
    gradient, dW alone where it is data) and bytes (the forward's again),
    the global-norm clip and Adam."""
    E, He, Hd = cfg["embed_size"], cfg["encoder_hidden"], cfg["decoder_hidden"]
    V, L, C = cfg["vocab_size"], cfg["latent_size"], cfg["num_clusters"]
    F, Kz = cfg["cnn_feature_size"], cfg["gen_z_samples"]
    M = images * captions

    def fwd_bwd(op: Op, products: int) -> Op:
        return Op(op.name, op.flops * products, op.bytes * 2)

    ops = [fwd_bwd(dense("image embedding", images, F, E, F32), 2),
           fwd_bwd(dense("cluster embedding", images, C, E, F32), 2)]
    for side, H, steps in (("encoder", He, 2), ("decoder", Hd, 3)):
        for _ in range(steps):
            ops.append(fwd_bwd(lstm_step(f"{side} init steps", M, E, H), 3))
        # the sequence: x in and h out a token (bf16), W once, the carry in
        # and out once a row (f32)
        ops.append(fwd_bwd(Op(f"{side} lstm sequence",
                              2.0 * tokens * (E + H) * 4 * H,
                              tokens * (E + H) * BF16 + (E + H) * 4 * H * BF16
                              + 4 * H * F32 + 4 * M * H * F32), 3))
    # AG: every cluster's (mu, log sigma), combined by c_v on the fly; GMM:
    # only the drawn cluster's; out [M, 2L] f32 either way
    width = 2 * C * L if cfg["prior"] == "AG" else 2 * L
    heads = Op("posterior heads", 2.0 * M * He * width,
               M * He * BF16 + He * 2 * C * L * BF16 + 2 * C * L * F32
               + (M * C + 2 * M * L) * F32)
    ops.append(fwd_bwd(heads, 3))
    ops.append(fwd_bwd(Op("z sample + projection", 2.0 * M * Kz * L * E,
                          (2 * M * L + M * E) * F32 + Kz * L * E * BF16), 3))
    ops.append(fwd_bwd(Op("logits head + CE", 2.0 * tokens * Hd * V,
                          tokens * (Hd * BF16 + I64) + Hd * V * BF16
                          + V * F32), 3))
    ops.append(Op("clip + Adam", 0.0, params * 8 * F32))
    return ops
