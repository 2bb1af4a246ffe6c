"""Vocabulary with the reference's exact id-assignment semantics (the
port's copy of ``vae_captioning_tpu/data/vocabulary.py``).

Reference (``utils/captions.py:66-129``): frequency-sorted words (ties
broken alphabetically), ids starting at 1, words below the min-count
filter dropped except ``<UNK>`` which is always kept, and ``<PAD>``
injected as id 0.  Reproducing this exactly matters: checkpoint / output
compatibility and CIDEr parity both depend on stable token ids.

Serialization is JSON (ordered word list), not pickle.  The file keeps
the JAX package's format tag, so a ``vocab.json`` written by either
package loads in the other.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Sequence

from vae_captioning_torch.data.tokenizer import BOS, EOS, PAD, UNK


class Vocabulary:
    def __init__(self, words_in_order: Sequence[str]):
        """``words_in_order``: vocabulary words for ids 1..N (id 0 = <PAD>)."""
        self._idx2word: Dict[int, str] = {0: PAD}
        self._word2idx: Dict[str, int] = {PAD: 0}
        for i, w in enumerate(words_in_order, start=1):
            self._idx2word[i] = w
            self._word2idx[w] = i

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, tokenized_captions: Iterable[List[str]],
              keep_words: int = 3) -> "Vocabulary":
        """Build from tokenized captions.

        Count every token (control tokens included, as the reference does —
        <BOS>/<EOS> appear once per caption so they always clear the
        filter); sort by (-count, word); keep count >= keep_words plus
        <UNK> unconditionally (ref utils/captions.py:108-118).
        """
        counter: Counter = Counter()
        for cap in tokenized_captions:
            counter.update(cap)
        counter[UNK] += 1  # reference appends '<UNK>' to the word stream
        ordered = sorted(counter.items(), key=lambda x: (-x[1], x[0]))
        words = [w for w, c in ordered if c >= keep_words or w == UNK]
        return cls(words)

    # -- lookups --------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self._idx2word)

    @property
    def word2idx(self) -> Dict[str, int]:
        return self._word2idx

    @property
    def idx2word(self) -> Dict[int, str]:
        return self._idx2word

    @property
    def pad_id(self) -> int:
        return 0

    @property
    def bos_id(self) -> int:
        return self._word2idx[BOS]

    @property
    def eos_id(self) -> int:
        return self._word2idx[EOS]

    @property
    def unk_id(self) -> int:
        return self._word2idx[UNK]

    def encode(self, tokens: List[str]) -> List[int]:
        """Tokens → ids with <UNK> fallback (ref utils/captions.py:43-60)."""
        unk = self.unk_id
        return [self._word2idx.get(t, unk) for t in tokens]

    def decode(self, ids: Iterable[int]) -> List[str]:
        return [self._idx2word[int(i)] for i in ids]

    def __len__(self) -> int:
        return len(self._idx2word)

    def __contains__(self, word: str) -> bool:
        return word in self._word2idx

    # -- serialization --------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        words = [self._idx2word[i] for i in range(1, self.vocab_size)]
        with open(path, "w") as f:
            json.dump({"format": "vae_captioning_tpu.vocab.v1",
                       "words": words}, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            payload = json.load(f)
        return cls(payload["words"])
