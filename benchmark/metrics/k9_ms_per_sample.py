"""K9 (the walk's render kernel): its mean launch time in the traced
window, one launch an image sample, in ms."""


def read(rec):
    if rec.trace is None:
        return None
    launches = rec.trace.kernels(r"^mega_walk_kernel<false>")
    return 1e3 * sum(launches) / len(launches) if launches else None
