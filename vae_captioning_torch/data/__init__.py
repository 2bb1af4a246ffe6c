"""The port's data layer (counterpart of ``vae_captioning_tpu/data``):
tokenizer, vocabulary, COCO captions, cluster vectors, feature caches,
the batcher and the ``Data`` facade.  numpy only."""

from vae_captioning_torch.data.tokenizer import tokenize_caption  # noqa: F401
from vae_captioning_torch.data.vocabulary import Vocabulary  # noqa: F401
from vae_captioning_torch.data.coco import CocoCaptions  # noqa: F401
