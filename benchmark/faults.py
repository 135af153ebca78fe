"""Faults planted under the timed path, to show that the check catches
them: each replaces an entry point in benchmark/port.py with a broken
one.  Used by the tests (on the CPU) and by calibrate.py (on the card).

  unchanged  the step returns its state unchanged: an image of nothing
             rendered, or gradients left at zero
  half       half of the batch left out, the mean taken over the rest:
             half of the samples of an image, half of the pixels' loss
  altered    an answer altered where it is produced: the image's sum, or
             the traced colors, off by 1%
"""

from __future__ import annotations

import contextlib

from benchmark import port

FAULTS = ("unchanged", "half", "altered")


def _render(kind: str):
    real = port.render_progressive

    def broken(scene, camera, seed=0, spp=None, **kw):
        if kind == "half":
            return real(scene, camera, seed=seed, spp=spp // 2, **kw)
        st = real(scene, camera, seed=seed, spp=spp, **kw)
        st.raw_sum = st.raw_sum * (0.0 if kind == "unchanged" else 1.01)
        return st

    return broken


def _loss(kind: str):
    real = port.image_loss

    def broken(img, target):
        if kind == "half":
            n = img.shape[0] // 2
            return real(img[:n], target[:n])
        if kind == "unchanged":
            return real(img.detach(), target).requires_grad_()
        return real(img * 1.01, target)

    return broken


@contextlib.contextmanager
def planted(kind: str):
    """The entry points of port.py broken by this fault inside the block."""
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")
    saved = port.render_progressive, port.image_loss
    port.render_progressive, port.image_loss = _render(kind), _loss(kind)
    try:
        yield
    finally:
        port.render_progressive, port.image_loss = saved
