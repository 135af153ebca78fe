"""Ray-stream orderings for the wavefront engine.

Port of distributed_raytracer_tpu/render/order.py.  The pool refills
lanes from a global ray stream; the pixel order of that stream decides
how coherent the rays in flight are, which is what a chunk walk's bound
tests key on.  tile_permutation walks the image in tiles.
"""

from __future__ import annotations

import numpy as np


def tile_permutation(width: int, height: int, tile_w: int = 32, tile_h: int = 16) -> np.ndarray:
    """Permutation p of pixel ids such that consecutive stream positions
    walk tile_w x tile_h image tiles; p[k] = pixel id at stream position k.
    Partial edge tiles are emitted last so full tiles stay contiguous."""
    ids = []
    tail = []
    for ty in range(0, height, tile_h):
        for tx in range(0, width, tile_w):
            full = (ty + tile_h <= height) and (tx + tile_w <= width)
            dst = ids if full else tail
            for y in range(ty, min(ty + tile_h, height)):
                dst.extend(y * width + x for x in range(tx, min(tx + tile_w, width)))
    out = np.asarray(ids + tail, np.int32)
    if out.size != width * height:
        raise AssertionError(f"tile permutation has {out.size} ids for {width}x{height}")
    return out


def inverse_permutation(p: np.ndarray) -> np.ndarray:
    """q with q[p[k]] = k."""
    inv = np.empty_like(p)
    inv[p] = np.arange(p.size, dtype=p.dtype)
    return inv
