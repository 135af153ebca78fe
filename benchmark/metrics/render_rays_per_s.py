"""Camera rays (pixels x samples) of every image completed in the window,
over the window's seconds."""


def read(rec):
    return rec.rays / rec.window_s
