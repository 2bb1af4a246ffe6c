"""Single-image caption API + CLI (counterpart of
``vae_captioning_tpu/generate.py``).

``Generator(checkpoint_dir, name)`` loads the JSON config / vocab
sidecars and the checkpoint's parameters once (``checkpoint.load_model``:
``params.npz``, or the newest train state), builds the decode functions
once per beam size, and then ``generate_caption(img_path)`` reads the
image, makes its fc2 features with VGG16 at batch 1 (a ``fine_tune``
checkpoint takes the raw pixels into its own VGG16) and decodes them,
on the card unless the caller asks for the CPU:

    python -m vae_captioning_torch.generate --img_path photo.jpg \\
        --checkpoint_dir ./checkpoints --checkpoint last_run \\
        [--gen_method beam_search --beam_size 3] [--device cpu]

As in the JAX package, and unlike the reference's ``gen_caption.py``:
the features come from the VGG16 / npz path used in training (no
separate Keras model with BGR mean subtraction), and the cluster vector
can be given, or read from a detector's output (``detections_json``).
``caption_pixels`` is the part of ``generate_caption`` that follows the
image read, for callers that hold the pixels already.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vae_captioning_torch.checkpoint import load_model, load_sidecars
from vae_captioning_torch.data import cluster_vectors as cv_lib
from vae_captioning_torch.data.features import FeatureExtractor
from vae_captioning_torch.data.images import load_image
from vae_captioning_torch.inference import (KERNEL_OPS, DecodeOps,
                                            make_decode_fns)
from vae_captioning_torch.ops.decoding import tokens_to_text

GEN_METHODS = ("greedy", "sample", "beam_search")


@functools.lru_cache(maxsize=4)
def feature_extractor(weights_path: str, compute_dtype: str,
                      device: str) -> FeatureExtractor:
    """VGG16 on ``weights_path`` at batch 1, built once a process for each
    (weights, dtype, device): the Generators of one process (the
    example's greedy and beam-search ones) share its weights."""
    return FeatureExtractor(weights_path, batch_size=1,
                            compute_dtype=compute_dtype, device=device)


class Generator:
    """Generate captions for arbitrary images from a trained checkpoint."""

    def __init__(self, checkpoint_dir: str = "./checkpoints",
                 name: str = "last_run", gen_method: str = "greedy",
                 weights_path: Optional[str] = None,
                 detections_json: Optional[str] = None,
                 device: torch.device | str = "cuda",
                 ops: DecodeOps = KERNEL_OPS):
        """``detections_json``: optional COCO-results-format detector
        output (``[{"image_id"|"file_name", "category_id", "score"}]``);
        the images found in it get detector-derived cluster vectors.
        ``weights_path`` overrides the config's ``vgg16_weights.npz``;
        ``ops`` picks the decode kernels or their plain versions."""
        cfg, vocab = load_sidecars(checkpoint_dir, name)
        if gen_method not in GEN_METHODS:
            raise ValueError(f"unknown gen_method {gen_method!r}")
        self.cfg = cfg.replace(sample_gen=gen_method)
        self.cfg.vocab_size = vocab.vocab_size
        self.vocab = vocab
        self.gen_method = gen_method
        self.weights_path = weights_path or cfg.image_net_weights_path
        self.device = torch.device(device)
        self.ops = ops
        self.model, _, _ = load_model(checkpoint_dir, name, self.device,
                                      self.cfg)
        # decode-fn sets cached per beam size: a repeated beam size does
        # not cast the weights (or quantise the head) again
        self._fns_by_beam: Dict[int, Dict[str, Callable]] = {
            self.cfg.beam_size: make_decode_fns(self.model, self.cfg, vocab,
                                                ops)}
        self._det_vectors: Optional[Dict[str, np.ndarray]] = None
        if detections_json:
            self._det_vectors = cv_lib.build_from_detections(
                cv_lib.load_detections_json(detections_json))
        self._extractor: Optional[FeatureExtractor] = None

    # ------------------------------------------------------------------
    def _features(self, pixels: np.ndarray) -> torch.Tensor:
        """The decode's input for pixels [1, S, S, 3]: VGG16's fc2 [1,
        4096] (:func:`feature_extractor`, taken at the first call), or the
        pixels themselves for a fine-tune model."""
        if self.cfg.fine_tune:
            return torch.from_numpy(np.ascontiguousarray(
                pixels, np.float32)).to(self.device)
        if self._extractor is None:
            self._extractor = feature_extractor(
                self.weights_path, str(self.cfg.compute_dtype),
                str(self.device))
        return self._extractor.features(pixels)

    def _cluster_vector(self, image_id: str,
                        cluster_vector: Optional[np.ndarray]) -> torch.Tensor:
        """[1, num_clusters]: the one given, else the detector's for this
        file (its 91-dim indicator sliced [1:], zeros when the file has
        no detection), else zeros."""
        cfg = self.cfg
        if cluster_vector is not None:
            vec = np.asarray(cluster_vector, np.float32)
        elif self._det_vectors is not None:
            vec = self._det_vectors.get(os.path.basename(image_id))
            if vec is None:
                vec = np.zeros(cfg.num_clusters + 1, np.float32)
            vec = np.asarray(vec, np.float32)[1:]
        else:
            vec = np.zeros(cfg.num_clusters, np.float32)
        return torch.from_numpy(vec[None].copy()).to(self.device)

    def decode_fns(self, beam_size: int) -> Dict[str, Callable]:
        """The decode functions at ``beam_size``, built once."""
        if beam_size not in self._fns_by_beam:
            self._fns_by_beam[beam_size] = make_decode_fns(
                self.model, self.cfg.replace(beam_size=beam_size), self.vocab,
                self.ops)
        return self._fns_by_beam[beam_size]

    # ------------------------------------------------------------------
    def generate_caption(self, img_path: str, beam_size: Optional[int] = None,
                         cluster_vector: Optional[np.ndarray] = None,
                         seed: Optional[int] = None,
                         return_beams: bool = False) -> List[Dict]:
        """→ ``[{'image_id': <file name>, 'caption': <str>}]`` (the
        reference's return shape).  ``return_beams=True`` (beam_search
        only) puts the best-first list of every beam's caption under
        'caption'.  The z noise is drawn from a generator seeded with
        ``seed``, or with the config's seed."""
        if not os.path.exists(img_path):
            raise FileNotFoundError(f"image not found: {img_path}")
        return self.caption_pixels(load_image(img_path)[None],
                                   os.path.basename(img_path), beam_size,
                                   cluster_vector, seed, return_beams)

    def caption_pixels(self, pixels: np.ndarray, image_id: str,
                       beam_size: Optional[int] = None,
                       cluster_vector: Optional[np.ndarray] = None,
                       seed: Optional[int] = None,
                       return_beams: bool = False) -> List[Dict]:
        """:meth:`generate_caption` on pixels [1, 224, 224, 3] (RGB,
        0..255, as ``data.images.load_image`` reads them) of the image
        whose file name is ``image_id``."""
        if return_beams and self.gen_method != "beam_search":
            raise ValueError("return_beams requires gen_method='beam_search'")
        beam = beam_size if beam_size is not None else self.cfg.beam_size
        fns = self.decode_fns(beam)
        features = self._features(pixels)
        c_v = self._cluster_vector(image_id, cluster_vector)
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed if seed is None else seed)
        vocab = self.vocab

        def text(row) -> str:
            return tokens_to_text(row, vocab.idx2word, vocab.eos_id,
                                  vocab.bos_id)

        if return_beams:
            tokens = fns["beam_search_all"](features, c_v,
                                            generator=generator).tokens
            caption = [text(row) for row in tokens[0].cpu().numpy()]
        else:
            tokens = fns[self.gen_method](features, c_v,
                                          generator=generator).tokens
            caption = text(tokens[0].cpu().numpy())
        return [{"image_id": image_id, "caption": caption}]


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Generate a caption for one image")
    p.add_argument("--img_path", required=True)
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--checkpoint", default="last_run")
    p.add_argument("--gen_method", default="greedy", choices=GEN_METHODS)
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--weights", default=None,
                   help="override vgg16_weights.npz path")
    p.add_argument("--detections", default=None,
                   help="detections JSON (COCO results format) for "
                        "detector-derived cluster vectors")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default: cuda)")
    args = p.parse_args(argv)
    gen = Generator(args.checkpoint_dir, args.checkpoint, args.gen_method,
                    weights_path=args.weights,
                    detections_json=args.detections, device=args.device)
    out = gen.generate_caption(args.img_path, beam_size=args.beam_size)
    print(out[0]["caption"])


if __name__ == "__main__":
    main()
