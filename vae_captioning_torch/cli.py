"""Command line of the port (``python -m vae_captioning_torch.cli``),
counterpart of ``vae_captioning_tpu/cli.py``.

* ``--mode training``: build the data, train with ``Trainer.fit``
  (``train.py``) and write ``config.json`` / ``vocab.json`` and, after
  every epoch, ``params.npz`` and the train state into
  ``<checkpoint_dir>/<checkpoint>/``.  With ``--restore`` a run resumes
  from the newest train state there, when one exists; with ``--set
  eval_metrics=True`` each epoch also prints val CIDEr-D, BLEU-4,
  ROUGE-L and METEOR_es (``inference.make_quality_hook``); with
  ``--fine_tune`` the model trains end to end through VGG16 on images.
  With ``--set multihost=True`` under ``torchrun`` each process is one
  rank of a data-parallel group (``parallel/``): NCCL where each rank
  has a GPU of its own, gloo otherwise; rank 0 writes the checkpoint.
  ``--set debug_nans=True`` raises at the first non-finite loss, metric
  or gradient norm and turns on autograd's anomaly detection.
  Configurations the train slice does not cover raise
  NotImplementedError (``train.check_supported_training``).
* ``--mode inference``: restore a checkpoint (``checkpoint.py``), decode
  the val split with ``--sample_gen`` and the test split greedily, and
  write ``val_<gen_name>.json`` / ``test_<gen_name>.json`` into the
  working directory.

The flags are the reference's (``config.py``, the port's copy of the
JAX package's) plus ``--device`` (default ``cuda``).  Features come from
the caches ``<cache_dir>/<split>.features.npz``; a missing cache is
extracted with VGG16 from ``image_net_weights_path`` on ``--device``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from vae_captioning_torch.checkpoint import (Checkpointer, load_model,
                                             load_sidecars, save_sidecars)
from vae_captioning_torch.config import Config, parse_args
from vae_captioning_torch.data.dataset import Data
from vae_captioning_torch.inference import (check_supported,
                                            make_quality_hook, run_inference)
from vae_captioning_torch.parallel import mesh
from vae_captioning_torch.train import Trainer, check_supported_training


def run_training(cfg: Config, device: torch.device,
                 data: Optional[Data] = None) -> Trainer:
    check_supported_training(cfg)
    if data is None:
        # rank 0 writes the caches, the other ranks then read them
        data = mesh.rank_zero_first(lambda: Data(
            cfg, extract_features=not cfg.fine_tune, device=device))
    trainer = Trainer(cfg, vocab_size=data.vocab.vocab_size, device=device)
    if trainer.is_main:
        save_sidecars(cfg, data.vocab, cfg.checkpoint_dir, cfg.checkpoint)
    ckpt = Checkpointer(cfg.checkpoint_dir, cfg.checkpoint,
                        cfg.max_checkpoints_to_keep)
    if cfg.restore and ckpt.latest_step() is not None:
        if trainer.is_main:
            print(f"Restoring from checkpoint step {ckpt.latest_step()}")
        trainer.restore_from(ckpt)
    quality_hook = None
    if cfg.eval_metrics:
        quality_hook = make_quality_hook(cfg, data.vocab,
                                         data.val_references())
    trainer.fit(data.train_batcher(), data.val_batcher(),
                checkpoint_dir=cfg.checkpoint_dir,
                checkpoint_name=cfg.checkpoint, quality_hook=quality_hook)
    return trainer


def run_inference_mode(cfg: Config, device: torch.device,
                       data: Optional[Data] = None) -> Dict[str, str]:
    if cfg.multihost:
        raise NotImplementedError("not ported yet: multihost decoding (the "
                                  "images split over ranks): ROADMAP A.9 rest")
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
        fused_decode=cfg.fused_decode, decode_int8=cfg.decode_int8,
        std=cfg.std)
    check_supported(model_cfg)
    if data is None:
        data = Data(model_cfg, extract_features=not model_cfg.fine_tune,
                    device=device)
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
                     help="torch device to train or decode on (default: cuda)")
    known, rest = pre.parse_known_args(argv)
    cfg = parse_args(rest)
    device = torch.device(known.device)
    if cfg.multihost and cfg.mode == "training":
        device = mesh.initialize_multihost(device)
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    try:
        if cfg.mode == "training":
            run_training(cfg, device)
        else:
            run_inference_mode(cfg, device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
