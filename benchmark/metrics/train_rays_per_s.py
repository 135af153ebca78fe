"""Camera rays of every gradient step completed in the window, over the
window's seconds."""


def read(rec):
    return rec.rays / rec.window_s
