"""VGG16 weight-fidelity checker (counterpart of
``vae_captioning_tpu/models/vgg_fidelity.py``).

The reference's caption quality depends on loading the Caffe-converted
``vgg16_weights.npz`` exactly: a wrong key order, layout or
preprocessing degrades it silently.  This tool reports whether the
port's VGG16 (``models/vgg16.py``, its loader included) reproduces an
independent oracle's fc2 features on that file:

    python -m vae_captioning_torch.models.vgg_fidelity \\
        --weights vgg16_weights.npz [--image some.jpg] [--device cpu]

The oracle is written here from the npz arrays alone, in f32 on the CPU
with plain ``torch.nn.functional`` calls on NCHW tensors and its own
NHWC flatten; it imports nothing of ``models/vgg16.py`` (its layer list
and ImageNet mean are its own copies), so agreement is evidence about
the loader and the architecture, not a tautology.  The path under test
runs on ``--device`` (the card by default), in f32 (no TF32) and, for
information, in the bf16 the feature extractor runs.  It exits 0 on
PASS, 1 on FAIL.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the reference architecture (utils/image_embeddings.py): conv layers by
# block, a 2x2 max-pool after each block
ORACLE_BLOCKS = (("conv1_1", "conv1_2"), ("conv2_1", "conv2_2"),
                 ("conv3_1", "conv3_2", "conv3_3"),
                 ("conv4_1", "conv4_2", "conv4_3"),
                 ("conv5_1", "conv5_2", "conv5_3"))
ORACLE_MEAN = (123.68, 116.779, 103.939)     # RGB


def oracle_fc2(weights_path: str, images: np.ndarray) -> np.ndarray:
    """Independent forward: images [B, 224, 224, 3] RGB 0..255 (f32 or
    uint8) → post-ReLU fc7 ("fc2") features [B, 4096], f32 on the CPU:
    mean-subtract → 13 conv3x3 (pad 1) + ReLU in 5 blocks with 2x2
    max-pool → NHWC flatten → fc6 ReLU → fc7 ReLU.  224 halves evenly
    five times, so TF's SAME pooling equals VALID here."""
    with np.load(weights_path) as raw:
        arrays = {k: np.asarray(raw[k], np.float32) for k in raw.files
                  if not k.startswith("fc8")}
    x = torch.from_numpy(np.asarray(images, np.float32)
                         - np.asarray(ORACLE_MEAN, np.float32))
    x = x.permute(0, 3, 1, 2)                               # NHWC -> NCHW
    with torch.no_grad():
        for block in ORACLE_BLOCKS:
            for name in block:
                w = torch.from_numpy(arrays[f"{name}_W"].transpose(3, 2, 0, 1)
                                     .copy())               # HWIO -> OIHW
                b = torch.from_numpy(arrays[f"{name}_b"])
                x = F.relu(F.conv2d(x, w, b, padding=1))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        for key in ("fc6", "fc7"):
            x = F.relu(x @ torch.from_numpy(arrays[f"{key}_W"])
                       + torch.from_numpy(arrays[f"{key}_b"]))
    return x.numpy()


def port_fc2(weights_path: str, images: np.ndarray,
             compute_dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cuda") -> np.ndarray:
    """The path under test: ``load_npz_weights`` → the port's VGG16 →
    fc2, on ``device``; in f32 with cuDNN's TF32 convolutions off, so
    the f32 run compares f32 sums."""
    from vae_captioning_torch.bridge import load_flax_params
    from vae_captioning_torch.models.vgg16 import VGG16, load_npz_weights

    model = VGG16(compute_dtype=compute_dtype)
    load_flax_params(model, load_npz_weights(weights_path))
    model.to(device).eval()
    cudnn = torch.backends.cudnn
    with torch.inference_mode(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic,
            allow_tf32=compute_dtype != torch.float32):
        out = model(torch.from_numpy(np.ascontiguousarray(images)).to(device))
    return out.cpu().numpy()


def fixed_image(image_path: Optional[str] = None,
                batch: int = 2) -> np.ndarray:
    """The comparison input: a real image through the train path's
    loader when given, else a seeded synthetic batch."""
    if image_path:
        from vae_captioning_torch.data.images import load_image
        img = load_image(image_path)
        return np.stack([img] * batch).astype(np.float32)
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(batch, 224, 224, 3)).astype(np.float32)


def compare(weights_path: str, image_path: Optional[str] = None,
            threshold: float = 1e-2, device: torch.device | str = "cuda",
            batch: int = 2) -> Tuple[bool, dict]:
    """Run both paths on ``batch`` images; PASS iff max|Δfc2| / max|oracle
    fc2| < threshold.

    f32 against f32 differs only by accumulation order (about 1e-4 after
    15 layers); a loader, layout or preprocessing fault gives an O(1)
    relative error, so 1e-2 separates the two."""
    images = fixed_image(image_path, batch)
    ref = oracle_fc2(weights_path, images)
    ours = port_fc2(weights_path, images, torch.float32, device)
    scale = float(np.abs(ref).max()) + 1e-12
    max_abs = float(np.abs(ours - ref).max())
    rel = max_abs / scale
    # informational: the bf16 extraction path against the f32 oracle
    ours_bf16 = port_fc2(weights_path, images, torch.bfloat16, device)
    rel_bf16 = float(np.abs(ours_bf16 - ref).max()) / scale
    report = {
        "fc2_scale": scale,
        "max_abs_diff_f32": max_abs,
        "rel_diff_f32": rel,
        "rel_diff_bf16_path": rel_bf16,
        "threshold": threshold,
        "nonzero_frac": float((ref > 0).mean()),
    }
    return rel < threshold, report


def main(argv=None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", required=True,
                   help="path to vgg16_weights.npz (Caffe conversion)")
    p.add_argument("--image", default=None,
                   help="optional real image; default: seeded synthetic")
    p.add_argument("--threshold", type=float, default=1e-2,
                   help="max relative fc2 difference to PASS")
    p.add_argument("--device", default="cuda",
                   help="torch device of the path under test (default: cuda)")
    args = p.parse_args(argv)
    ok, report = compare(args.weights, args.image, args.threshold,
                         args.device)
    print(json.dumps({"verdict": "PASS" if ok else "FAIL", **report},
                     indent=2))
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
