"""What a gradient step spends outside the program's own CUDA kernels: its
span less the time those kernels ran inside it, averaged over steps."""


def read(rec):
    if rec.trace is None or not rec.trace.spans:
        return None
    per = rec.trace.inside_spans(rec.port_kernels)
    return 1e3 * sum(span - busy for span, busy in per) / len(per)
