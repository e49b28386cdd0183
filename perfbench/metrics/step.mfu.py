"""The whole step's share of the chip's float32 peak: the useful model
FLOPs of the window (from the shapes and the decisions the program
counted) over the window's seconds and 67 TFLOP/s, in %."""
from perfbench.roofline.model import FP32_FLOPS


def read(run):
    if not run.window_flops:
        return None
    return 100.0 * run.window_flops / (run.window_s * FP32_FLOPS)
