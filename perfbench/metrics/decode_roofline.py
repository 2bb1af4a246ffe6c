"""The decode window's work at its roofline (perfbench/counts.py: each
operation's products at the bf16 peak or its bytes at the memory rate,
the larger) over the device's busy time in the traced window, in %."""


def read(w):
    if w.trace is None or w.trace.busy_s <= 0 or w.bound_s <= 0:
        return None
    return 100.0 * w.bound_s / w.trace.busy_s
