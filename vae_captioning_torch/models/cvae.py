"""The captioning model, decode half (counterpart of
``vae_captioning_tpu/models/cvae.py``).

One module covers the reference's variants at decode time: the
no-encoder baseline (no z), and the Normal, GMM and AG-prior CVAEs, which
draw z from the prior.  The AG prior centres z on the mean of the
image's active cluster means.  The encoder, the training forward and the
loss wait for the train-step slice; their Flax parameters are reported
by the bridge as not yet consumed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vae_captioning_tpu.config import Config
from vae_captioning_torch.models.decoder import Decoder, LSTMStep
from vae_captioning_torch.ops import distributions as dist
from vae_captioning_torch.ops.lstm import Carry


class CVAEModel(nn.Module):
    """Construct via ``CVAEModel.from_config(cfg)``.  The decoder computes
    in bf16 with f32 accumulation, the reference's default compute dtype;
    ``make_decode_fns`` rejects configurations with another one."""

    def __init__(self, vocab_size: int, embed_size: int = 256,
                 latent_size: int = 150, decoder_hidden: int = 512,
                 decoder_layers: int = 1, num_clusters: int = 90,
                 gen_z_samples: int = 100, prior: str = "Normal",
                 no_encoder: bool = False, use_c_v: bool = False,
                 decode_std: float = 0.1, cluster_seed: int = 0,
                 cnn_feature_size: int = 4096):
        super().__init__()
        self.latent_size = latent_size
        self.gen_z_samples = gen_z_samples
        self.prior = prior
        self.no_encoder = no_encoder
        self.use_c_v = use_c_v
        self.decode_std = decode_std
        self.imf_emb = nn.Linear(cnn_feature_size, embed_size)
        self.cv_emb = (nn.Linear(num_clusters, embed_size)
                       if self.needs_c_v else None)
        self.decoder = Decoder(
            vocab_size, embed_size, decoder_hidden, decoder_layers,
            use_c_v=use_c_v,
            z_input_size=None if no_encoder else gen_z_samples * latent_size)
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
            cnn_feature_size=cfg.cnn_feature_size)

    @property
    def needs_c_v(self) -> bool:
        return self.use_c_v or self.prior in ("GMM", "AG")

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
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(embedding [V, E], lstm kernel [E+H, 4H], lstm bias [4H]) of the
    decoder's single-layer cell, for the fused LSTM step kernel."""
    dec = model.decoder
    cell = dec.lstm.cells[0]
    return dec.dec_embeddings.weight, cell.kernel, cell.bias
