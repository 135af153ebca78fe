"""Process start to the first timed request: imports, CUDA context, the
kernel libraries, the scene and the warm-up of the cell's own shapes."""


def read(rec):
    return rec.setup_s
