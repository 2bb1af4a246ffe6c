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
one.  The Normal head returns (μ, exp(log σ)); the AG head returns the
c_v-weighted combination of the 90 per-cluster posteriors through
``heads_fn`` (``ops/fused_ag_heads.py``); the GMM head returns the
posterior of one cluster per row, drawn from the law c_v gives
(``distributions.sample_clusters``) and picked by index, which is exact
as the JAX package's one-hot contraction at HIGHEST precision is.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from vae_captioning_torch.ops.distributions import sample_clusters
from vae_captioning_torch.ops.fused_ag_heads import fused_ag_heads
from vae_captioning_torch.ops.fused_lstm_seq import fused_lstm_seq
from vae_captioning_torch.ops.lstm import LSTMStack, SeqFn

# (h [B, H], w [2·K·L, H], b [2·K·L], c_v [B, K]) → (q_mean, q_std)
HeadsFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
# the GMM head's draw: cluster indices [B], or a generator that draws them
Clusters = Union[torch.Tensor, torch.Generator, None]


class Encoder(nn.Module):
    def __init__(self, vocab_size: int, embed_size: int, hidden_size: int,
                 latent_size: int, num_layers: int = 1,
                 prior: str = "Normal", num_clusters: int = 90,
                 use_c_v: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.prior = prior
        self.use_c_v = use_c_v
        self.latent_size = latent_size
        self.enc_embeddings = nn.Embedding(vocab_size, embed_size)
        self.lstm = LSTMStack(embed_size, hidden_size, num_layers,
                              compute_dtype)
        half = latent_size if prior == "Normal" else num_clusters * latent_size
        self.q_heads = nn.Linear(hidden_size, 2 * half)

    def forward(self, images_fv: torch.Tensor, captions: torch.Tensor,
                lengths: torch.Tensor, c_emb: Optional[torch.Tensor] = None,
                c_v: Optional[torch.Tensor] = None,
                seq_fn: SeqFn = fused_lstm_seq,
                heads_fn: HeadsFn = fused_ag_heads,
                clusters: Clusters = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images_fv [B, E], captions [B, T] (w1..wN <EOS>), lengths [B],
        c_emb [B, E], c_v [B, 90] (the AG head's cluster weights, the GMM
        head's cluster law) → the posterior (mean, std), each [B, L] f32.
        ``clusters``, the GMM head's draw: indices [B], or a generator on
        the device that draws them."""
        if self.prior in ("AG", "GMM") and c_v is None:
            raise ValueError(f"the {self.prior} prior needs cluster vectors c_v")
        if self.prior == "GMM" and clusters is None:
            raise ValueError("the GMM prior draws a cluster per row: pass "
                             "clusters (indices or a torch.Generator)")
        carry = self.lstm.zero_carry(images_fv.shape[0], images_fv.device)
        carry, _ = self.lstm.step(carry, images_fv)
        if c_emb is not None and self.use_c_v:
            carry, _ = self.lstm.step(carry, c_emb)
        carry, _ = self.lstm(carry, self.enc_embeddings(captions), lengths,
                             collect_outputs=False, seq_fn=seq_fn)
        # the reference reads the first layer's hidden state
        h = carry[0][1]
        if self.prior == "AG":
            return heads_fn(h, self.q_heads.weight, self.q_heads.bias, c_v)
        q = self.q_heads(h)
        L = self.latent_size
        if self.prior == "Normal":
            return q[:, :L], torch.exp(q[:, L:])
        B, K = c_v.shape
        idx = (clusters if isinstance(clusters, torch.Tensor)
               else sample_clusters(c_v, clusters)).to(q.device)
        rows = torch.arange(B, device=q.device)
        mean = q[:, :K * L].reshape(B, K, L)[rows, idx]
        return mean, torch.exp(q[:, K * L:].reshape(B, K, L)[rows, idx])
