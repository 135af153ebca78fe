"""K8 (the reverse walk of the tape): its device time in the traced
window over the gradient steps completed there."""


def read(rec):
    if rec.trace is None or not rec.units.get("steps"):
        return None
    launches = rec.trace.kernels(r"^mega_walk_bwd_kernel\b")
    return 1e3 * sum(launches) / rec.units["steps"] if launches else None
