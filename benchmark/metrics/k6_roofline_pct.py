"""K6 in camera mode (the recording forward of the dense training step):
the least time of its sample at the float32 peak, from the reference's
count of the sweep's operations, over K6's mean launch time."""

from benchmark.roofline import roofline_pct


def read(rec):
    if rec.trace is None:
        return None
    launches = rec.trace.kernels(r"^mega_forward_kernel<false>")
    return roofline_pct(rec.work(), launches) if launches else None
