"""Best-beam captions of the batches the window completed, over the
window (host clock, from the first request to the last batch's captions
on the host)."""


def read(w):
    return w.captions / w.seconds if w.batches else None
