"""VGG16 vision backbone (counterpart of ``vae_captioning_tpu/models/vgg16.py``).

13 3x3 convs in 5 blocks with 2x2 max-pool, then fc1 / fc2 (4096); fc2
(post-ReLU) is the image feature.  Callers feed raw RGB in [0, 255] (f32,
or the packed stores' uint8); the ImageNet mean is subtracted in f32
before the cast to ``compute_dtype`` (bf16), so uint8 never wraps.

The convs are cuDNN's (``F.conv2d``, work the reference left to XLA) on
NCHW tensors in ``channels_last`` memory, i.e. NHWC in memory.  fc1's
[25088, 4096] Flax kernel is laid out for an NHWC flatten, so the
activations are flattened in that order: permuting a ``channels_last``
tensor to NHWC is a view, and the flatten copies nothing.  The master
weights are f32 (the Flax ``param_dtype``) and are cast to
``compute_dtype`` in the forward; the Flax parameter names (``conv1_1``
.. ``conv5_3``, ``fc1``, ``fc2``) are the module names, so the bridge
carries them both ways.  Dropout on fc1 / fc2 runs only when
``trainable_top`` and a generator is given (training), with the keep rate
``dropout_keep``.

``load_npz_weights`` reads the Caffe-converted ``vgg16_weights.npz`` by
name (``conv1_1_W`` .. ``fc7_b``; fc8, the 1000-way classifier, is
dropped) into the Flax tree, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (name, out_channels) per conv layer; a pool after each block
CONV_BLOCKS = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)
IMAGENET_MEAN = (123.68, 116.779, 103.939)  # RGB
FEATURE_SIZE = 4096


class VGG16(nn.Module):
    """images [B, S, S, 3] (RGB, 0..255) → fc2 [B, 4096] f32.  S = 224
    for the reference's weights (fc1 reads (S/32)² · 512 inputs)."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_keep: float = 1.0, trainable_top: bool = False,
                 image_size: int = 224):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_keep = dropout_keep
        self.trainable_top = trainable_top
        in_ch = 3
        for block in CONV_BLOCKS:
            for name, out_ch in block:
                self.add_module(name, nn.Conv2d(in_ch, out_ch, 3, padding=1))
                in_ch = out_ch
        side = image_size // 32
        self.fc1 = nn.Linear(side * side * in_ch, FEATURE_SIZE)
        self.fc2 = nn.Linear(FEATURE_SIZE, FEATURE_SIZE)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)

    def forward(self, images: torch.Tensor,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        x = (images.float() - self.mean).to(dtype)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for block in CONV_BLOCKS:
            for name, _ in block:
                conv = getattr(self, name)
                x = F.relu(F.conv2d(x, conv.weight.to(dtype),
                                    conv.bias.to(dtype), padding=1))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        for fc in (self.fc1, self.fc2):
            x = F.relu(F.linear(x, fc.weight.to(dtype), fc.bias.to(dtype)))
            x = self._dropout(x, dropout)
        return x.float()

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        keep = self.dropout_keep
        if not self.trainable_top or keep >= 1.0 or generator is None:
            return x
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


def load_npz_weights(weights_path: str) -> Dict[str, Any]:
    """The Caffe-converted npz (``conv1_1_W`` .. ``conv5_3_b``, ``fc6_W``
    .. ``fc8_b``) as the Flax VGG16 tree ``{conv1_1: {kernel, bias}, ..,
    fc1, fc2}``: fc6 / fc7 become fc1 / fc2 and fc8 is dropped.  A missing
    key raises KeyError, a wrong shape ValueError."""
    params: Dict[str, Any] = {}
    with np.load(weights_path) as raw:
        for block in CONV_BLOCKS:
            for name, features in block:
                kernel = np.asarray(raw[f"{name}_W"], np.float32)
                bias = np.asarray(raw[f"{name}_b"], np.float32)
                if kernel.shape[-1] != features:
                    raise ValueError(f"{name}: expected {features} filters, "
                                     f"got {kernel.shape}")
                params[name] = {"kernel": kernel, "bias": bias}
        for ours, caffe in (("fc1", "fc6"), ("fc2", "fc7")):
            params[ours] = {"kernel": np.asarray(raw[f"{caffe}_W"], np.float32),
                            "bias": np.asarray(raw[f"{caffe}_b"], np.float32)}
    if params["fc1"]["kernel"].shape != (25088, FEATURE_SIZE):
        raise ValueError("fc6 kernel must be [25088, 4096] "
                         f"(got {params['fc1']['kernel'].shape})")
    return params
