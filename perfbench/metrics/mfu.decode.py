"""The decode window's model FLOPs (perfbench/counts.py) over the window
at the chip's bf16 peak, in %."""

from perfbench.counts import PEAK_BF16


def read(w):
    if w.trace is None or w.trace.kernels == 0 or w.flops <= 0:
        return None
    return 100.0 * w.flops / (w.trace.window_s * PEAK_BF16)
