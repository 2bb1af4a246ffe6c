"""Caption tokenization (the port's copy of
``vae_captioning_tpu/data/tokenizer.py``).

Byte-for-byte the reference's scheme (``utils/captions.py:38-41``):
lowercase, split on non-word runs (``\\W+``), drop empties, wrap in
``<BOS>`` / ``<EOS>``.  Kept as a tiny pure function so the vocabulary,
the batcher, and the single-image API all share one tokenizer.
"""

from __future__ import annotations

import re
from typing import List

BOS = "<BOS>"
EOS = "<EOS>"
PAD = "<PAD>"
UNK = "<UNK>"

_SPLIT = re.compile(r"\W+")


def tokenize_caption(caption: str) -> List[str]:
    """``"A man, riding."`` → ``['<BOS>', 'a', 'man', 'riding', '<EOS>']``."""
    return [BOS] + [t for t in _SPLIT.split(caption.lower()) if t] + [EOS]


def detokenize(tokens: List[str]) -> str:
    """Join generated tokens into a caption, dropping control tokens
    (ref ``vae_model/decoder.py:198-199``)."""
    return " ".join(t for t in tokens if t not in (BOS, EOS, PAD))
