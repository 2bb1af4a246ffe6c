"""Seconds from the process's start to the window's: imports, CUDA
initialisation, the kernels' load (and nvcc at a checkout's first run),
weights, inputs and warm-up."""


def read(w):
    return w.setup_s
