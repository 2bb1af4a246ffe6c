"""torch.cuda.max_memory_allocated over the window, after a reset at its
start, in MiB."""


def read(w):
    return w.peak_bytes / 2 ** 20 if w.peak_bytes else None
