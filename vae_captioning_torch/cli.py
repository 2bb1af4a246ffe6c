"""Command line of the port (``python -m vae_captioning_torch.cli``),
counterpart of ``vae_captioning_tpu/cli.py``.

Inference only: restore a checkpoint (``checkpoint.py``), decode the val
split with ``--sample_gen`` and the test split greedily, and write
``val_<gen_name>.json`` / ``test_<gen_name>.json`` into the working
directory.  The flags are the reference's (``vae_captioning_tpu.config``)
plus ``--device`` (default ``cuda``).  Training is not ported yet.

Features come from the caches ``<cache_dir>/<split>.features.npz``
only: extracting them needs the VGG16 model, which is not ported yet, so
a missing cache raises instead of reaching the JAX extractor.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from vae_captioning_tpu.config import Config, parse_args
from vae_captioning_tpu.data.coco import coco_paths
from vae_captioning_tpu.data.dataset import Data
from vae_captioning_torch.checkpoint import load_model, load_sidecars
from vae_captioning_torch.inference import check_supported, run_inference


def check_feature_caches(cfg: Config) -> None:
    """Every split the inference pass reads needs its feature cache."""
    paths = coco_paths(cfg.coco_dir)
    split_dirs = [paths["valid_dir"]]
    test_dir = paths["test_dir"]
    if os.path.isdir(test_dir) and any(f.endswith(".jpg")
                                       for f in os.listdir(test_dir)):
        split_dirs.append(test_dir)
    for split_dir in split_dirs:
        split = os.path.basename(os.path.normpath(split_dir))
        cache = os.path.join(cfg.cache_dir, f"{split}.features.npz")
        if not os.path.exists(cache):
            raise FileNotFoundError(
                f"no feature cache {cache}: feature extraction (VGG16) is "
                "not ported yet (ROADMAP A.8); extract the features with "
                "python -m vae_captioning_tpu.data.features first")


def run_inference_mode(cfg: Config, device: torch.device,
                       data: Optional[Data] = None) -> Dict[str, str]:
    # the training-time config gives the model's shape; decode flags and
    # paths come from this run
    saved_cfg, vocab = load_sidecars(cfg.checkpoint_dir, cfg.checkpoint)
    model_cfg = saved_cfg.replace(
        mode="inference", sample_gen=cfg.sample_gen,
        beam_size=cfg.beam_size, temperature=cfg.temperature,
        gen_batch_size=cfg.gen_batch_size, gen_name=cfg.gen_name,
        coco_dir=cfg.coco_dir, hdf5_file=cfg.hdf5_file,
        raw_images_file=cfg.raw_images_file,
        checkpoint=cfg.checkpoint, checkpoint_dir=cfg.checkpoint_dir,
        std=cfg.std)
    check_supported(model_cfg)
    if data is None:
        check_feature_caches(model_cfg)
        data = Data(model_cfg, extract_features=True)
    model_cfg.vocab_size = vocab.vocab_size   # Data sets its own vocab's
    print("Restoring from checkpoint")
    model, _, _ = load_model(model_cfg.checkpoint_dir, model_cfg.checkpoint,
                             device, model_cfg)
    return run_inference(model_cfg, model, vocab,
                         data.val_batcher(model_cfg.gen_batch_size),
                         data.test_batcher(model_cfg.gen_batch_size))


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="torch device to decode on (default: cuda)")
    known, rest = pre.parse_known_args(argv)
    cfg = parse_args(rest)
    if cfg.mode == "training":
        raise NotImplementedError(
            "training is not ported yet (ROADMAP A.6); use "
            "python -m vae_captioning_tpu.cli for training")
    run_inference_mode(cfg, torch.device(known.device))


if __name__ == "__main__":
    main()
