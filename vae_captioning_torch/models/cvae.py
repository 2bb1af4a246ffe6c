"""The captioning model and its loss (counterpart of
``vae_captioning_tpu/models/cvae.py``).

One module covers the reference's variants: the no-encoder baseline (no
z), and the Normal, GMM and AG-prior CVAEs.  At decode time z is drawn
from the prior; the AG prior centres it on the mean of the image's
active cluster means, every other prior at 0.  The training forward runs
the encoder (with the AG heads kernel, or the GMM head's cluster draw),
the fused z sampling + projection and teacher forcing; the loss takes
the CE over bf16 logits, or a fused CE over the decoder's hidden rows
(``Config.fused_ce``, ``ce_hybrid`` or ``ce_xla_bwd``).  Every Flax parameter of every prior has its
counterpart here.  The model computes in ``Config.compute_dtype``: bf16
through the kernels (``KERNEL_TRAIN_OPS``), or f32 (``F32_TRAIN_OPS``):
the LSTMs, z and AG heads in plain f32 PyTorch, as the JAX package gates
those kernels on bf16, and the CE kernels under a CE flag, which it does
not gate; :func:`train_ops` picks them from the configuration.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from vae_captioning_torch.config import Config
from vae_captioning_torch.models.decoder import Decoder, LSTMStep
from vae_captioning_torch.models.encoder import Clusters, Encoder
from vae_captioning_torch.ops import distributions as dist
from vae_captioning_torch.ops.f32 import (ag_heads_f32, lstm_seq_f32,
                                          torch_dtype, z_project_f32)
from vae_captioning_torch.ops.fused_ag_heads import (ag_heads_plain,
                                                     fused_ag_heads)
from vae_captioning_torch.ops.fused_ce import (
    fused_linear_ce, fused_linear_ce_hybrid, fused_linear_ce_hybrid_plain,
    fused_linear_ce_plain, fused_linear_ce_xla_bwd,
    fused_linear_ce_xla_bwd_plain, linear_ce)
from vae_captioning_torch.ops.fused_lstm_seq import (fused_lstm_seq,
                                                     fused_lstm_seq_plain)
from vae_captioning_torch.ops.fused_z import fused_z, fused_z_plain
from vae_captioning_torch.ops.lstm import Carry, Dropout


class TrainOps(NamedTuple):
    """The train path's kernel operations.  The train step uses the
    kernel wrappers; comparisons on the card and the tests swap in the
    plain versions (or a ``sample_project`` with explicit eps).  The
    three CE functions are the schedules of ``Config.fused_ce``,
    ``ce_hybrid`` and ``ce_xla_bwd``."""

    lstm_seq: Callable = fused_lstm_seq
    sample_project: Callable = fused_z
    ag_heads: Callable = fused_ag_heads
    linear_ce: Callable = fused_linear_ce
    linear_ce_hybrid: Callable = fused_linear_ce_hybrid
    linear_ce_xla_bwd: Callable = fused_linear_ce_xla_bwd


KERNEL_TRAIN_OPS = TrainOps()
PLAIN_TRAIN_OPS = TrainOps(fused_lstm_seq_plain, fused_z_plain,
                           ag_heads_plain, fused_linear_ce_plain,
                           fused_linear_ce_hybrid_plain,
                           fused_linear_ce_xla_bwd_plain)
# compute_dtype="float32", the JAX package's route (ops/f32.py): the LSTM
# sequence, the z and the AG heads in plain f32, as its bf16-gated kernels
# give way to XLA there; a CE schedule flag keeps its kernels, which cast
# the f32 hidden rows and head to bf16 as the JAX CE kernels do.
F32_TRAIN_OPS = KERNEL_TRAIN_OPS._replace(lstm_seq=lstm_seq_f32,
                                          sample_project=z_project_f32,
                                          ag_heads=ag_heads_f32)


def train_ops(cfg: Config, ops: Optional[TrainOps] = None) -> TrainOps:
    """The train path's operations for ``cfg``: ``ops`` where given, else
    the kernels under bf16 and ``F32_TRAIN_OPS`` under f32."""
    if ops is not None:
        return ops
    if torch_dtype(cfg.compute_dtype) == torch.float32:
        return F32_TRAIN_OPS
    return KERNEL_TRAIN_OPS


class CVAEModel(nn.Module):
    """Construct via ``CVAEModel.from_config(cfg)``.  The LSTMs and the
    logits head compute in ``compute_dtype``: bf16 with f32 accumulation,
    the reference's default, or f32."""

    def __init__(self, vocab_size: int, embed_size: int = 256,
                 latent_size: int = 150, decoder_hidden: int = 512,
                 decoder_layers: int = 1, num_clusters: int = 90,
                 gen_z_samples: int = 100, prior: str = "Normal",
                 no_encoder: bool = False, use_c_v: bool = False,
                 decode_std: float = 0.1, cluster_seed: int = 0,
                 cnn_feature_size: int = 4096, encoder_hidden: int = 512,
                 encoder_layers: int = 1, dec_keep_rate: float = 1.0,
                 dec_lstm_drop: float = 1.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.latent_size = latent_size
        self.gen_z_samples = gen_z_samples
        self.prior = prior
        self.no_encoder = no_encoder
        self.use_c_v = use_c_v
        self.decode_std = decode_std
        self.imf_emb = nn.Linear(cnn_feature_size, embed_size)
        self.cv_emb = (nn.Linear(num_clusters, embed_size)
                       if self.needs_c_v else None)
        self.encoder = None if no_encoder else Encoder(
            vocab_size, embed_size, encoder_hidden, latent_size,
            encoder_layers, prior, num_clusters, use_c_v, compute_dtype)
        self.decoder = Decoder(
            vocab_size, embed_size, decoder_hidden, decoder_layers,
            use_c_v=use_c_v,
            z_input_size=None if no_encoder else gen_z_samples * latent_size,
            dec_keep_rate=dec_keep_rate, dec_lstm_drop=dec_lstm_drop,
            compute_dtype=compute_dtype)
        # fixed (non-trainable) cluster means, deterministic in the seed
        self.register_buffer("cluster_means", torch.from_numpy(
            dist.init_cluster_means(num_clusters, latent_size, cluster_seed)))

    @classmethod
    def from_config(cls, cfg: Config) -> "CVAEModel":
        if not cfg.vocab_size:
            raise ValueError("set cfg.vocab_size (from the Vocabulary) first")
        return cls(
            vocab_size=cfg.vocab_size, embed_size=cfg.embed_size,
            latent_size=cfg.latent_size, decoder_hidden=cfg.decoder_hidden,
            decoder_layers=cfg.decoder_rnn_layers,
            num_clusters=cfg.num_clusters, gen_z_samples=cfg.gen_z_samples,
            prior=cfg.prior, no_encoder=cfg.no_encoder, use_c_v=cfg.use_c_v,
            decode_std=cfg.std, cluster_seed=cfg.seed,
            cnn_feature_size=cfg.cnn_feature_size,
            encoder_hidden=cfg.encoder_hidden,
            encoder_layers=cfg.encoder_rnn_layers,
            dec_keep_rate=cfg.dec_keep_rate, dec_lstm_drop=cfg.dec_lstm_drop,
            compute_dtype=torch_dtype(cfg.compute_dtype))

    @property
    def needs_c_v(self) -> bool:
        return self.use_c_v or self.prior in ("GMM", "AG")

    # ------------------------------------------------------------------
    def forward(self, features: torch.Tensor, enc_captions: torch.Tensor,
                dec_captions: torch.Tensor, lengths: torch.Tensor,
                c_v: Optional[torch.Tensor] = None, z_seed: int = 0,
                z_step: int = 0, ops: TrainOps = KERNEL_TRAIN_OPS,
                time_major: bool = True,
                dropout: Dropout = None,
                return_hidden: bool = False, clusters: Clusters = None
                ) -> Dict[str, torch.Tensor]:
        """Training and eval forward.  features [B, 4096], enc_captions
        [B·K, T] (w1..wN <EOS>), dec_captions [B·K, T] (<BOS> w1..wN),
        lengths [B·K], c_v [B, 90] → {"logits": [T, B·K, V] bf16 (or [B·K,
        T, V] without ``time_major``), "q_mean", "q_std": [B·K, L] f32,
        "c_v": [B·K, 90] when c_v is given}; with ``return_hidden``,
        "hidden" [T, B·K, H] (the decoder's LSTM outputs, bf16) in place
        of "logits".  K is read from the shapes and the image rows and
        cluster vectors are repeated K times after the embedding.
        (z_seed, z_step) key the fused z noise; ``dropout`` (a generator,
        or a callable giving the masks) turns on the caption-input dropout
        and the decoder's LSTM output dropout; ``clusters`` is the GMM head's
        draw over the B·K rows (indices or a generator)."""
        B = features.shape[0]
        K = enc_captions.shape[0] // B
        images_fv = self.imf_emb(features.float())
        c_emb = None
        if c_v is not None:
            c_v = c_v.float()
            if self.needs_c_v:
                c_emb = self.cv_emb(c_v)
        if K > 1:
            images_fv = images_fv.repeat_interleave(K, dim=0)
            c_emb = None if c_emb is None else c_emb.repeat_interleave(K, dim=0)
            c_v = None if c_v is None else c_v.repeat_interleave(K, dim=0)
        out: Dict[str, torch.Tensor] = {}
        z_dec = None
        if not self.no_encoder:
            q_mean, q_std = self.encoder(images_fv, enc_captions, lengths,
                                         c_emb, c_v, seq_fn=ops.lstm_seq,
                                         heads_fn=ops.ag_heads,
                                         clusters=clusters)
            z_dec = self.decoder.sample_z_embedding_fused(
                q_mean, q_std, self.gen_z_samples, z_seed, z_step,
                ops.sample_project)
            out["q_mean"], out["q_std"] = q_mean, q_std
        carry = self.decoder.init_state(images_fv, c_emb, z_dec,
                                        dropout=dropout)
        out["hidden" if return_hidden else "logits"] = (
            self.decoder.teacher_forcing(
                carry, dec_captions, lengths, seq_fn=ops.lstm_seq,
                time_major=time_major, dropout=dropout,
                return_hidden=return_hidden))
        if c_v is not None:
            out["c_v"] = c_v
        return out

    # ------------------------------------------------------------------
    def decode_init(self, features: torch.Tensor,
                    c_v: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    lstm_step: Optional[LSTMStep] = None) -> Carry:
        """Generation-time initial LSTM state: features [B, 4096], c_v
        [B, 90] → carry.  z ~ N(z_mean, decode_std²) with z_mean = 0,
        except under the AG prior, which centres it on the image's active
        cluster means; the K_z draws are made in the projected space
        (``Decoder.gen_z_embedding``) from ``eps`` or ``generator``.
        ``lstm_step`` runs the conditioning steps (``Decoder.init_state``);
        the decode fns pass theirs, on weights cast once."""
        images_fv = self.imf_emb(features.float())
        c_emb = None
        if self.needs_c_v and c_v is not None:
            c_emb = self.cv_emb(c_v.float())
        z_dec = None
        if not self.no_encoder:
            if self.prior == "AG" and c_v is not None:
                z_mean = dist.ag_prior_mean(c_v.float(), self.cluster_means)
            else:
                z_mean = torch.zeros((features.shape[0], self.latent_size),
                                     device=features.device)
            z_dec = self.decoder.gen_z_embedding(
                z_mean, self.decode_std, self.gen_z_samples, eps=eps,
                generator=generator)
        return self.decoder.init_state(images_fv, c_emb, z_dec, lstm_step)

    def decode_step(self, carry: Carry, tokens: torch.Tensor
                    ) -> Tuple[Carry, torch.Tensor]:
        """tokens [B] → (carry, logits [B, V])."""
        return self.decoder.step(carry, tokens)

    def decode_step_hidden(self, carry: Carry, tokens: torch.Tensor
                           ) -> Tuple[Carry, torch.Tensor]:
        """tokens [B] → (carry, hidden [B, H])."""
        return self.decoder.step_hidden(carry, tokens)


def logits_head_params(model: CVAEModel) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel [H, V], bias [V]) of the decoder's rnn_logits head in the
    Flax layout, for the fused logits + top-k kernel."""
    head = model.decoder.rnn_logits
    return head.weight.t(), head.bias


def decoder_step_params(model: CVAEModel
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                                   Tuple[torch.Tensor, ...]]:
    """(embedding [V, E], the lstm kernels [in+H, 4H] and biases [4H] of
    every decoder layer, ``cell_0`` first), for the fused LSTM step
    kernel."""
    dec = model.decoder
    cells = dec.lstm.cells
    return (dec.dec_embeddings.weight, tuple(c.kernel for c in cells),
            tuple(c.bias for c in cells))


# ----------------------------------------------------------------------
# loss
# ----------------------------------------------------------------------

def compute_loss(outputs: Dict[str, torch.Tensor], labels: torch.Tensor,
                 *, no_encoder: bool, prior: str = "Normal",
                 cluster_means: Optional[torch.Tensor] = None,
                 cluster_sigma: float = 0.1, annealing=1.0,
                 logits_params: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 gmm_true_kl: bool = False, ag_kl_sum: bool = False,
                 time_major: bool = True, ce_fn: Optional[Callable] = None,
                 counts: Optional[Tuple[float, float]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Masked CE + the prior's KL + annealing → the lower bound.

    rec: softmax CE at every position, PAD (label 0) masked, the mean
    taken over real tokens.  Over ``outputs["logits"]`` (bf16) it is plain
    PyTorch with f32 sums, as the JAX package's plain CE branch; over
    ``outputs["hidden"]`` it is a fused CE (``ops/fused_ce.py``, through
    ``ce_fn``, by default the flash CE's kernel wrapper) with the
    ``rnn_logits`` (weight [V, H], bias [V]) given as ``logits_params``.
    total = rec + annealing·kld/10.  kld: the AG KL against the
    c_v-weighted cluster means (``outputs["c_v"]``, ``cluster_means``
    [90, L]; summed over rows with ``ag_kl_sum``, else meaned) under the
    AG prior; under the GMM prior the Hershey-Olsen mixture bound with
    ``gmm_true_kl``, else, as the reference's placeholder, the
    standard-normal KL, which the Normal prior takes.  ``labels`` is [T,
    B·K] when the forward ran ``time_major`` (as the train step runs
    it), else [B·K, T].  ``counts``, where given, are the means' divisors
    (tokens of the CE, rows of the KL) in place of this batch's own: on
    data-parallel ranks, the global batch's (``parallel/kernel_shard.py``),
    so each rank's loss is its share of the global loss."""
    tokens, rows = (None, None) if counts is None else counts
    if "hidden" in outputs:
        w, b = logits_params
        rec_loss = linear_ce(outputs["hidden"], w, b, labels, ce_fn, tokens)
    else:
        logits = outputs["logits"]
        m = logits.detach().amax(dim=-1, keepdim=True)
        sumexp = torch.exp((logits - m).float()).sum(dim=-1)
        lse = torch.log(sumexp) + m[..., 0].float()
        label_logit = torch.gather(logits, -1, labels.long().unsqueeze(-1))
        ce = lse - label_logit[..., 0].float()
        mask = (labels != 0).float()
        rec_loss = (ce * mask).sum() / (
            torch.clamp(mask.sum(), min=1.0) if tokens is None
            else max(tokens, 1.0))
    # rows that are all padding do not count in the KL either
    row_mask = (labels != 0).any(dim=0 if time_major else -1)
    if no_encoder:
        kld = torch.zeros((), dtype=torch.float32, device=labels.device)
    elif prior == "AG":
        kld = dist.kl_ag(outputs["q_mean"], outputs["q_std"], outputs["c_v"],
                         cluster_means, cluster_sigma, row_mask=row_mask,
                         reduce="sum" if ag_kl_sum else "mean", rows=rows)
    elif prior == "GMM" and gmm_true_kl:
        kld = dist.kl_gmm(outputs["q_mean"], outputs["q_std"], outputs["c_v"],
                          cluster_means, cluster_sigma, row_mask=row_mask,
                          rows=rows)
    else:
        kld = dist.kl_standard_normal(outputs["q_mean"], outputs["q_std"],
                                      row_mask=row_mask, rows=rows)
    annealing = torch.as_tensor(annealing, dtype=torch.float32,
                                device=labels.device)
    return {"loss": rec_loss + annealing * kld / 10.0, "rec_loss": rec_loss,
            "kld": kld, "annealing": annealing}
