"""Image post-processing and output in numpy: gamma-2, clamp and byte
quantization, packing into 0xFFRRGGBB display words, and a binary PPM
writer and reader (the port's own copy of distributed_raytracer_tpu/
render/image.py)."""

from __future__ import annotations

import numpy as np

INTENSITY_MIN = 0.0
INTENSITY_MAX = 0.999


def linear_to_gamma(linear: np.ndarray) -> np.ndarray:
    """Gamma-2: sqrt of the positive part."""
    return np.sqrt(np.maximum(linear, 0.0))


def to_bytes(linear_rgb: np.ndarray) -> np.ndarray:
    """Linear [..., 3] float -> uint8 via gamma, clamp and a 255.999 scale."""
    g = linear_to_gamma(np.asarray(linear_rgb))
    q = 255.999 * np.clip(g, INTENSITY_MIN, INTENSITY_MAX)
    return q.astype(np.uint8)


def pack_argb(linear_rgb: np.ndarray) -> np.ndarray:
    """Linear [..., 3] float -> uint32 [...] 0xFFRRGGBB, the display
    buffer's word (render/display.py)."""
    b = to_bytes(linear_rgb).astype(np.uint32)
    return (np.uint32(255) << 24) | (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]


def write_ppm(path: str, linear_rgb: np.ndarray) -> None:
    """Write a linear [H, W, 3] image as a binary P6 PPM."""
    img = to_bytes(linear_rgb)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM back as uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(b"\n", 3)
    if parts[0] != b"P6" or len(parts) < 4 or parts[2] != b"255":
        raise ValueError(f"{path}: not a binary P6 PPM with maxval 255")
    w, h = (int(x) for x in parts[1].split())
    pixels = np.frombuffer(parts[3][: w * h * 3], dtype=np.uint8)
    return pixels.reshape(h, w, 3)
