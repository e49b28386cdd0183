"""Seconds from the start of the process to the start of the window:
imports, the CUDA context, the kernel library (built on a checkout's
first run), the inputs and weights from the seed, and the warm-up steps."""


def read(run):
    return run.setup_s
