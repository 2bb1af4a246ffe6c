"""B x K captions times the steps the window completed (all of them on
the device at its close), over the window (host clock)."""


def read(w):
    return w.captions / w.seconds if w.batches else None
