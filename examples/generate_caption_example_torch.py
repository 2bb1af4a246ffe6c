"""End-user demo of the PyTorch port: caption one image from a trained
checkpoint (``params.npz`` or a train state, with its ``config.json`` and
``vocab.json``), on the card unless ``--device cpu`` is given.  Usage:

    python examples/generate_caption_example_torch.py \
        --img_path some_image.jpg --checkpoint_dir ./checkpoints \
        --checkpoint last_run [--beam_size 2] [--device cpu]
"""

import argparse

from vae_captioning_torch.generate import Generator


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--img_path", required=True)
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--checkpoint", default="last_run")
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--detections", default=None,
                   help="detections JSON (COCO results format, e.g. a "
                        "Faster-RCNN pass): images found in it decode "
                        "with detector-derived cluster vectors")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default: cuda)")
    args = p.parse_args()

    # greedy first (fast), then beam search, as the reference's notebook
    greedy = Generator(args.checkpoint_dir, args.checkpoint,
                       gen_method="greedy", detections_json=args.detections,
                       device=args.device)
    out = greedy.generate_caption(args.img_path)
    print(f"greedy      : {out[0]['caption']}")

    beam = Generator(args.checkpoint_dir, args.checkpoint,
                     gen_method="beam_search",
                     detections_json=args.detections, device=args.device)
    out = beam.generate_caption(args.img_path, beam_size=args.beam_size)
    print(f"beam (k={args.beam_size}) : {out[0]['caption']}")


if __name__ == "__main__":
    main()
