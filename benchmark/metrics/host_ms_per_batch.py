"""Host time of a batch of samples: the image requests' spans (submission
to mean image in host memory) less the device activity inside them, over
the batches rendered."""


def read(rec):
    if rec.trace is None or not rec.trace.spans or not rec.units.get("batches"):
        return None
    per = rec.trace.inside_spans()
    return 1e3 * sum(span - busy for span, busy in per) / rec.units["batches"]
