"""Data parallelism over processes joined by ``torch.distributed``
(counterpart of ``vae_captioning_tpu/parallel``)."""
