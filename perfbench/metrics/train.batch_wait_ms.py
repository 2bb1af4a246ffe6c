"""Mean host ms a step waits for its batch: the batcher's next batch
(behind the Prefetcher) and Trainer.device_batch, whose copies to the
card wait for the device."""


def read(w):
    if w.batches == 0 or "device_batch" not in w.spans:
        return None
    return (w.spans["next_batch"] + w.spans["device_batch"]) / w.batches * 1e3
