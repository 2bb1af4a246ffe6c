"""The share of the traced train window in which no device operation
ran, in %."""


def read(w):
    if w.trace is None or w.trace.kernels == 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
