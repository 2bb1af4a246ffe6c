"""Caption decoder p(x | z, f(I)) (counterpart of
``vae_captioning_tpu/models/decoder.py``).

The init-state protocol is kept: step the LSTM on the embedded image
feature, optionally on the embedded cluster vector, then on the
z-projection; the resulting carry seeds teacher-forced training and
incremental decoding alike.  At train time the z step input comes from
the fused z sampling + projection (``ops/fused_z.py``), the caption runs
through the masked sequence layer and the ``rnn_logits`` head computes
in ``compute_dtype`` (bf16 by default, or f32).  Under training,
``dec_lstm_drop`` < 1 drops each LSTM layer's outputs, in the
conditioning steps and in the caption sequence (``ops/lstm.py``).

Submodule names follow the Flax tree (``dec_embeddings``, ``lstm``,
``z_rnn``, ``rnn_logits``) so the bridge maps them one to one.  The
Dense layers are ``nn.Linear``s, whose weight is the Flax kernel
transposed.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from vae_captioning_torch.ops.f32 import logits_f32
from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq
from vae_captioning_torch.ops.fused_z import fused_z
from vae_captioning_torch.ops.lstm import (Carry, Dropout, LSTMStack, SeqFn,
                                           drop)

# one LSTM step of the whole stack: (carry, x [B, E]) → (carry, h [B, H])
LSTMStep = Callable[[Carry, torch.Tensor], Tuple[Carry, torch.Tensor]]


class Decoder(nn.Module):
    def __init__(self, vocab_size: int, embed_size: int, hidden_size: int,
                 num_layers: int = 1, use_c_v: bool = False,
                 z_input_size: Optional[int] = None,
                 dec_keep_rate: float = 1.0, dec_lstm_drop: float = 1.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.use_c_v = use_c_v
        self.dec_keep_rate = dec_keep_rate   # caption-input dropout
        self.compute_dtype = compute_dtype
        self.dec_embeddings = nn.Embedding(vocab_size, embed_size)
        # dec_lstm_drop: the keep rate of the LSTM outputs
        self.lstm = LSTMStack(embed_size, hidden_size, num_layers,
                              compute_dtype, output_keep_rate=dec_lstm_drop)
        # z_rnn exists only for the CVAE variants (K_z·L → E); the
        # no-encoder baseline never projects a z
        self.z_rnn = (nn.Linear(z_input_size, embed_size)
                      if z_input_size else None)
        self.rnn_logits = nn.Linear(hidden_size, vocab_size)

    # ------------------------------------------------------------------
    def init_state(self, images_fv: torch.Tensor,
                   c_emb: Optional[torch.Tensor] = None,
                   z_dec: Optional[torch.Tensor] = None,
                   step: Optional[LSTMStep] = None,
                   dropout: Dropout = None) -> Carry:
        """images_fv, c_emb, z_dec: [B, E] → carry after the conditioning
        steps.  ``step`` (carry, x) → (carry, h) runs each of them; by
        default ``self.lstm.step``, with the LSTM output dropout of
        ``dropout`` (a layer's dropped output feeds the next layer)."""
        if step is None:
            def step(carry, x):
                return self.lstm.step(carry, x, dropout)
        carry = self.lstm.zero_carry(images_fv.shape[0], images_fv.device)
        carry, _ = step(carry, images_fv)
        if c_emb is not None and self.use_c_v:
            carry, _ = step(carry, c_emb)
        if z_dec is not None:
            carry, _ = step(carry, z_dec)
        return carry

    # ------------------------------------------------------------------
    def gen_z_embedding(self, z_mean: torch.Tensor, std: float,
                        n_samples: int,
                        eps: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Generation-time z step input [B, E], drawn in the PROJECTED
        space: the projection of K_z iid draws of N(z_mean, std²I) is
        Gaussian with mean ``z_mean @ Σ_s W_s + b`` and covariance
        ``std²·WᵀW`` (W = the z_rnn kernel, [K_z·L, E]), so an E-dim draw
        shaped by a Cholesky factor of WᵀW (plus a 1e-6·max(diag)
        jitter) has the same law.  All in f32.  ``eps`` [B, E] ~ N(0, I)
        is drawn from ``generator`` unless given."""
        kernel = self.z_rnn.weight.t().float()              # [K_z·L, E]
        L = z_mean.shape[-1]
        E = kernel.shape[-1]
        w_sum = kernel.reshape(n_samples, L, E).sum(dim=0)  # [L, E]
        mean_part = z_mean.float() @ w_sum + self.z_rnn.bias.float()
        cov = kernel.t() @ kernel                           # [E, E]
        jitter = 1e-6 * torch.diagonal(cov).max()
        chol = torch.linalg.cholesky(
            cov + jitter * torch.eye(E, device=cov.device, dtype=cov.dtype))
        if eps is None:
            eps = torch.randn((z_mean.shape[0], E), generator=generator,
                              device=z_mean.device, dtype=torch.float32)
        noise = eps.float() @ chol.t()
        return mean_part + float(std) * noise

    # ------------------------------------------------------------------
    def sample_z_embedding_fused(self, q_mean: torch.Tensor,
                                 q_std: torch.Tensor, n_samples: int,
                                 seed: int, step: int,
                                 sample_project: Callable = fused_z
                                 ) -> torch.Tensor:
        """Train-time z step input [B, E] (bf16 from the fused z; f32
        from ``ops/f32.py``'s ``z_project_f32``): ``z_rnn`` of the K_z
        reparameterised draws of N(q_mean, q_std²), sampled and projected
        keyed on (seed, step) (``ops/fused_z.py``)."""
        return sample_project(q_mean, q_std, self.z_rnn.weight,
                              self.z_rnn.bias, n_samples, seed, step)

    def teacher_forcing(self, carry: Carry, dec_inputs: torch.Tensor,
                        lengths: torch.Tensor, seq_fn: SeqFn = fused_lstm_seq,
                        time_major: bool = False,
                        dropout: Dropout = None,
                        return_hidden: bool = False) -> torch.Tensor:
        """Full-sequence logits in ``compute_dtype``: dec_inputs [B, T]
        (<BOS> w1 ...), lengths [B] → [B, T, V], or [T, B, V] with
        ``time_major`` (the train step's layout).  The bf16 head rounds as
        the Flax Dense with ``dtype=bfloat16`` does: bf16(h16 @ W16) +
        bf16(b).  With ``dropout`` (a generator, or a callable giving the
        masks), ``dec_keep_rate`` < 1 drops the inputs out first and
        ``dec_lstm_drop`` < 1 each LSTM layer's outputs.
        ``return_hidden`` returns the LSTM outputs [B, T, H] / [T, B, H]
        instead, the input of the flash CE (``ops/fused_ce.py``)."""
        x = drop(self.dec_embeddings(dec_inputs), dropout, self.dec_keep_rate)
        _, hs = self.lstm(carry, x, lengths, time_major_out=time_major,
                          seq_fn=seq_fn, dropout=dropout)
        if return_hidden:
            return hs
        if self.compute_dtype == torch.float32:
            return logits_f32(hs, self.rnn_logits.weight.t(), self.rnn_logits.bias)
        bf16 = torch.bfloat16
        w16 = self.rnn_logits.weight.to(bf16).t()
        return torch.matmul(hs.to(bf16), w16) + self.rnn_logits.bias.to(bf16)

    # ------------------------------------------------------------------
    def step_hidden(self, carry: Carry, tokens: torch.Tensor
                    ) -> Tuple[Carry, torch.Tensor]:
        """One decode step stopping at the hidden state [B, H], the input
        of the fused logits + top-k kernel."""
        x = self.dec_embeddings(tokens)
        return self.lstm.step(carry, x)

    def step(self, carry: Carry, tokens: torch.Tensor
             ) -> Tuple[Carry, torch.Tensor]:
        """One decode step: tokens [B] → (carry, logits [B, V] f32).  The
        head computes in ``compute_dtype``, so the bf16 logits are rounded
        to it, as the Flax Dense with ``dtype=compute_dtype`` rounds them."""
        carry, h = self.step_hidden(carry, tokens)
        if self.compute_dtype == torch.float32:
            return carry, logits_f32(h, self.rnn_logits.weight.t(),
                                     self.rnn_logits.bias)
        bf16 = torch.bfloat16
        w = self.rnn_logits.weight.t().to(bf16).float()
        logits = (h.to(bf16).float() @ w).to(bf16) + self.rnn_logits.bias.to(bf16)
        return carry, logits.float()
