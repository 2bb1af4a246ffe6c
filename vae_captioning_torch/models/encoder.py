"""CVAE recognition network q(z | x, f(I)) (counterpart of
``vae_captioning_tpu/models/encoder.py``).

The init-state protocol is kept: step the LSTM once on the embedded
image feature, optionally once more on the embedded cluster vector, then
run the caption through the masked sequence layer and read the final
hidden state of the first layer.  One dense head ``q_heads`` gives
(μ ‖ log σ).

Submodule names follow the Flax tree (``enc_embeddings``, ``lstm``,
``q_heads``), and ``q_heads`` has its per-prior shape (2·L for Normal,
2·90·L for GMM and AG), so the bridge maps every prior's tree one to
one.  Only the Normal head runs: the GMM and AG heads come with their
training slices (ROADMAP A.6 and B.5) and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq
from vae_captioning_torch.ops.lstm import LSTMStack, SeqFn


class Encoder(nn.Module):
    def __init__(self, vocab_size: int, embed_size: int, hidden_size: int,
                 latent_size: int, num_layers: int = 1,
                 prior: str = "Normal", num_clusters: int = 90,
                 use_c_v: bool = False):
        super().__init__()
        self.prior = prior
        self.use_c_v = use_c_v
        self.latent_size = latent_size
        self.enc_embeddings = nn.Embedding(vocab_size, embed_size)
        self.lstm = LSTMStack(embed_size, hidden_size, num_layers)
        half = latent_size if prior == "Normal" else num_clusters * latent_size
        self.q_heads = nn.Linear(hidden_size, 2 * half)

    def forward(self, images_fv: torch.Tensor, captions: torch.Tensor,
                lengths: torch.Tensor, c_emb: Optional[torch.Tensor] = None,
                seq_fn: SeqFn = fused_lstm_seq
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images_fv [B, E], captions [B, T] (w1..wN <EOS>), lengths [B],
        c_emb [B, E] → the posterior (mean, std), each [B, L] f32."""
        if self.prior != "Normal":
            raise NotImplementedError(
                f"not ported yet: the {self.prior} posterior heads "
                "(ROADMAP B.5 for AG, A.6 for GMM)")
        carry = self.lstm.zero_carry(images_fv.shape[0], images_fv.device)
        carry, _ = self.lstm.step(carry, images_fv)
        if c_emb is not None and self.use_c_v:
            carry, _ = self.lstm.step(carry, c_emb)
        carry, _ = self.lstm(carry, self.enc_embeddings(captions), lengths,
                             collect_outputs=False, seq_fn=seq_fn)
        # the reference reads the first layer's hidden state
        q = self.q_heads(carry[0][1])
        L = self.latent_size
        return q[:, :L], torch.exp(q[:, L:])
