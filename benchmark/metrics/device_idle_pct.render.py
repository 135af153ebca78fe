"""Share of the traced window of a render cell in which nothing ran on
the card: 1 - (union of device activity) / window."""


def read(rec):
    if rec.trace is None or not rec.trace.window_s:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
