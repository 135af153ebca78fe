"""K5 (the dense render kernel): the least time of one sample at the
float32 peak, from the reference's count of the sweep's operations, over
K5's mean launch time in the traced window."""

from benchmark.roofline import roofline_pct


def read(rec):
    if rec.trace is None:
        return None
    launches = rec.trace.kernels(r"^mega_render_kernel\b")
    return roofline_pct(rec.work(), launches) if launches else None
