"""The hand kernel ``fake_quant``'s share of its roofline: the least time its
launches in the traced segment need (bytes at 3.35 TB/s or float32
operations at 67 TFLOP/s, from the shapes of the calls) over the device
time the profiler gives kernels named ``fake_quant_*``, in %."""
from perfbench.roofline.model import bound_s
from perfbench.trace import kernel_seconds


def read(run):
    if run.trace is None:
        return None
    calls = run.sut.kernel_calls(run.traced_steps).get("fake_quant")
    took = kernel_seconds(run.trace, "fake_quant_")
    if not calls or took <= 0:
        return None
    return 100.0 * sum(bound_s(b, f)[0] for b, f in calls) / took
