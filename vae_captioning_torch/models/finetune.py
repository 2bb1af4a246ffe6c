"""End-to-end fine-tune model: VGG16 backbone + CVAE head in one module
(counterpart of ``vae_captioning_tpu/models/finetune.py``).

Raw 224x224 images feed VGG16 (dropout on fc1 / fc2 while training, from
an explicit generator), and its fc2 features feed the CVAE, whose train
forward runs the train kernels as on features.  The parameter tree is
the Flax one, ``{"vgg16": ..., "cvae": ...}`` (the module names), so the
bridge loads and exports it; the optimizer routes ``vgg16/conv*`` and
``vgg16/fc*`` to their own, possibly frozen, chains
(``train.make_finetune_optimizer``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from vae_captioning_torch.bridge import flatten
from vae_captioning_torch.config import Config
from vae_captioning_torch.models.cvae import CVAEModel
from vae_captioning_torch.models.vgg16 import VGG16, load_npz_weights
from vae_captioning_torch.ops.lstm import Carry

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


class FineTuneModel(nn.Module):
    """Construct via ``FineTuneModel.from_config(cfg)``."""

    def __init__(self, vgg16: VGG16, cvae: CVAEModel):
        super().__init__()
        self.vgg16 = vgg16
        self.cvae = cvae

    @classmethod
    def from_config(cls, cfg: Config) -> "FineTuneModel":
        vgg = VGG16(compute_dtype=DTYPES[str(cfg.compute_dtype)],
                    dropout_keep=cfg.cnn_dropout if cfg.mode == "training"
                    else 1.0,
                    trainable_top=True, image_size=cfg.image_size)
        return cls(vgg, CVAEModel.from_config(cfg))

    def forward(self, images: torch.Tensor, *args,
                cnn_dropout: Optional[torch.Generator] = None,
                **kwargs) -> Dict[str, torch.Tensor]:
        """images [B, S, S, 3] → the CVAE's train / eval forward on their
        fc2 features (the other arguments are ``CVAEModel.forward``'s);
        ``cnn_dropout`` turns on VGG16's dropout."""
        return self.cvae(self.vgg16(images, cnn_dropout), *args, **kwargs)

    def decode_init(self, images: torch.Tensor, *args, **kwargs) -> Carry:
        """``CVAEModel.decode_init`` on the images' fc2 features."""
        return self.cvae.decode_init(self.vgg16(images), *args, **kwargs)


def cvae_of(model: nn.Module) -> CVAEModel:
    """The captioning model inside ``model`` (a FineTuneModel's CVAE, or
    ``model`` itself)."""
    return model.cvae if isinstance(model, FineTuneModel) else model


def load_vgg_into_params(params: Mapping[str, Any], weights_path: str
                         ) -> Dict[str, Any]:
    """Replace the ``vgg16/*`` keys of a flat Flax tree with the Caffe-npz
    ImageNet weights (the reference loads them on every fresh run)."""
    out = {k: v for k, v in flatten(params).items()
           if not k.startswith("vgg16/")}
    out.update(flatten({"vgg16": load_npz_weights(weights_path)}))
    return out
