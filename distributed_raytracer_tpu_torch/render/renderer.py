"""The scan engine: sample passes over ray tiles on the reference bounce.
The port of distributed_raytracer_tpu/render/renderer.py.

Samples outermost, pixels in tiles of tile_size rays, each tile traced to
the camera's depth by ops/trace.py (trace_rays_fast, or trace_rays with
differentiable=True).  The draws are JAX's: sample s of the image takes
fold_in(key, s), tile k of it fold_in(that, k), split into the camera
key and the trace key, so the color of (pixel, sample) is a function of
(key, sample, tile partition) and equals JAX's, and any split of the
samples into batches gives the same sum.  The last tile is padded with
pixel 0, which is rendered and dropped, so every tile draws at JAX's
shape.  No kernel runs here: the bounce is plain PyTorch, on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, generate_rays
from distributed_raytracer_tpu_torch.ops.trace import trace_rays, trace_rays_fast

DEFAULT_TILE = 32768


def render_sample_batch(scene: Scene, camera: Camera, key: torch.Tensor,
                        sample_indices: Iterable[int], tile_size: int = DEFAULT_TILE,
                        differentiable: bool = False) -> torch.Tensor:
    """The SUM over sample_indices of full-image passes, [H*W, 3] linear
    color, on the scene's device (scene and camera on one device).
    sample_indices are global sample numbers, folded into key.
    differentiable=True traces with autograd (trace_rays).  The rays are
    traced in the scene's dtype (float32; also float64 on the CPU, which
    referees float32 rounding in tests)."""
    dev, dt = scene.centers.device, scene.centers.dtype
    w = camera.image_width
    n_pix = camera.num_pixels
    tile = min(tile_size, n_pix)
    n_tiles = -(-n_pix // tile)
    ids = torch.zeros(n_tiles * tile, dtype=torch.int64, device=dev)
    ids[:n_pix] = torch.arange(n_pix, device=dev)  # padded ids re-render pixel 0
    tracer = trace_rays if differentiable else trace_rays_fast
    acc = torch.zeros(n_pix, 3, dtype=dt, device=dev)
    for s in sample_indices:
        sample_key = prng.fold_in(key, int(s))
        colors = []
        for k in range(n_tiles):
            k_cam, k_trace = prng.split(prng.fold_in(sample_key, k))
            tids = ids[k * tile:(k + 1) * tile]
            o, d = generate_rays(camera, tids % w, tids // w, key=k_cam)
            colors.append(tracer(scene, o.to(dt), d.to(dt), k_trace, camera.max_depth))
        acc = acc + torch.cat(colors)[:n_pix]
    return acc


def render_image(scene: Scene, camera: Camera, seed: int = 0, spp: Optional[int] = None,
                 batch: int = 16, tile_size: int = DEFAULT_TILE, progress_cb=None,
                 device=None) -> np.ndarray:
    """A full image, the linear mean color [H, W, 3] f32 on the host:
    PRNGKey(seed), batches of `batch` samples summed in order.
    progress_cb(samples_done, running mean [H, W, 3]) after each batch."""
    spp = spp if spp is not None else camera.samples_per_pixel
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    key = prng.PRNGKey(seed)
    acc = torch.zeros(camera.num_pixels, 3, dtype=torch.float32, device=dev)
    done = 0
    while done < spp:
        n = min(batch, spp - done)
        acc = acc + render_sample_batch(scene, camera, key, range(done, done + n), tile_size)
        done += n
        if progress_cb is not None:
            mean = acc.cpu().numpy() / done
            progress_cb(done, mean.reshape(camera.image_height, camera.image_width, 3))
    img = acc.cpu().numpy() / spp
    return img.reshape(camera.image_height, camera.image_width, 3)
