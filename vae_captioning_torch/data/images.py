"""Host-side image IO (the port's copy of
``vae_captioning_tpu/data/images.py``; ``cv2`` and ``h5py`` are imported
inside the functions that need them).

``load_image`` reproduces the reference's pixel pipeline
(``utils/image_utils.py:5-13``): cv2 imread → resize to 224×224 (bilinear)
→ BGR→RGB → grayscale→3-channel fix.  Output is float32 RGB in [0, 255];
ImageNet mean subtraction happens on the device inside the VGG16 module.

``Hdf5ImageStore`` + ``pack_images_to_hdf5`` replace ``preprocess.py`` and
the HDF5 fast path of ``utils/batch_gen.py:34-42,278-288``: all JPEGs
packed once into a uint8 ``(N, 224, 224, 3)`` dataset with a JSON
name→row-index sidecar, so fine-tune epochs are IO-bound on one large
sequential file rather than 120k JPEG decodes.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

IMAGE_SIZE = 224


def load_image(path: str, size: int = IMAGE_SIZE) -> np.ndarray:
    """Load one image as float32 RGB [size, size, 3] in [0, 255]."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    img = cv2.resize(img, (size, size))
    if img.ndim == 2 or img.shape[-1] == 1:
        img = np.stack([np.squeeze(img)] * 3, axis=-1)
    else:
        img = img[:, :, ::-1]  # BGR -> RGB
    return np.ascontiguousarray(img, dtype=np.float32)


def load_image_batch(paths: Sequence[str], size: int = IMAGE_SIZE) -> np.ndarray:
    return np.stack([load_image(p, size) for p in paths])


class Hdf5ImageStore:
    """Random access into a packed uint8 image HDF5 file."""

    def __init__(self, hdf5_path: str, index_path: Optional[str] = None):
        import h5py

        self._h5 = h5py.File(hdf5_path, "r")
        self.images = self._h5["images"]
        index_path = index_path or hdf5_path + ".index.json"
        with open(index_path) as f:
            self.name_to_row: Dict[str, int] = json.load(f)

    def get_batch(self, filenames: Sequence[str]) -> np.ndarray:
        """Fetch images for filenames; h5py requires *strictly increasing*
        indices, so read the sorted unique rows and expand back to the
        request order — this also makes duplicate filenames in one batch
        legal (ref utils/batch_gen.py:152-162 sorted the *batch*
        instead)."""
        rows = np.asarray([self.name_to_row[os.path.basename(fn)]
                           for fn in filenames])
        uniq, inverse = np.unique(rows, return_inverse=True)
        data = self.images[uniq.tolist()]
        # uint8 through host batching and the device transfer (4× less
        # traffic); VGG16 subtracts the mean in f32 on the device
        return data[inverse]

    def close(self) -> None:
        self._h5.close()


def pack_images_to_hdf5(image_dirs: Sequence[str], output_h5: str,
                        size: int = IMAGE_SIZE) -> Dict[str, int]:
    """Pack every ``*.jpg`` under ``image_dirs`` into one HDF5 dataset.

    Replaces ``preprocess.py:10-46``; the name→row map is JSON next to the
    file rather than a pickle.
    """
    import h5py

    paths: List[str] = []
    for d in image_dirs:
        paths.extend(sorted(glob(os.path.join(d, "*.jpg"))))
    if not paths:
        raise FileNotFoundError(f"no jpgs under {image_dirs}")
    os.makedirs(os.path.dirname(os.path.abspath(output_h5)), exist_ok=True)
    name_to_row: Dict[str, int] = {}
    with h5py.File(output_h5, "w") as h5:
        dset = h5.create_dataset(
            "images", shape=(len(paths), size, size, 3), dtype="uint8")
        for i, p in enumerate(paths):
            dset[i] = load_image(p, size).astype(np.uint8)
            name_to_row[os.path.basename(p)] = i
    with open(output_h5 + ".index.json", "w") as f:
        json.dump(name_to_row, f)
    return name_to_row


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Pack COCO jpgs into one HDF5 "
                                "file for fast fine-tune epochs")
    p.add_argument("--image_dirs", nargs="+", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    index = pack_images_to_hdf5(args.image_dirs, args.output)
    print(f"packed {len(index)} images into {args.output}")


if __name__ == "__main__":
    main()
