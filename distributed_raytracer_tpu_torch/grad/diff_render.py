"""Differentiable rendering, dL/dscene and dL/dcamera: the port of
distributed_raytracer_tpu/grad/diff_render.py.

render_diff is the scan engine (render/renderer.py) with autograd on:
camera rays, the fixed-depth bounce loop and the accumulation are tensor
code, so torch.autograd reaches the scene's five float fields and, through
ops/camera.py's derive, the camera pose.  The noise is fixed by the key
(the same draws for any parameter value), so the gradient is the pathwise
one and finite differences check it; visibility edges are not
differentiated (a silhouette crossing a pixel is a step), and the
dielectric's reflect/refract choice is frozen per draw, as in JAX.

Eager autograd keeps every bounce's tensors until the backward (JAX wraps
each bounce in jax.checkpoint); the scan engine's memory so grows with
pixels x samples x depth, which keeps it to small images.  InverseRenderer
with engine="tape" trains on the host-loop tape tracer instead
(grad/tapegrad.py), whose backward replays a tape.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, generate_rays, reinitialize
from distributed_raytracer_tpu_torch.render.renderer import DEFAULT_TILE, render_sample_batch

# camera pose fields exposed to differentiation
CAMERA_POSE_FIELDS = ("vfov", "lookfrom", "lookat", "vup", "defocus_angle", "focus_dist")


def image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-squared error in linear color space."""
    return torch.mean((img - target.reshape(img.shape)) ** 2)


def render_diff(scene: Scene, camera: Camera, key: torch.Tensor, sample_indices: Iterable[int],
                tile_size: int = DEFAULT_TILE) -> torch.Tensor:
    """Differentiable mean image [H*W, 3], linear color, on the scene's
    device (scene and camera on one device)."""
    samples = [int(s) for s in sample_indices]
    total = render_sample_batch(scene, camera, key, samples, tile_size, differentiable=True)
    return total / len(samples)


def _leaves(fields: Dict[str, torch.Tensor], dev) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to(dev).clone().requires_grad_() for k, v in fields.items()}


def scene_grads(scene: Scene, camera: Camera, key: torch.Tensor, sample_indices, target,
                tile_size: int = DEFAULT_TILE, device=None) -> Tuple[torch.Tensor, dict]:
    """(loss, dL/d{centers, radii, albedo, fuzz, ior}) against a target
    image [H*W, 3].  Runs on the CUDA card unless device says otherwise."""
    dev = resolve_device(device)
    params = _leaves(scene.diff_params(), dev)
    tgt = torch.as_tensor(target, dtype=torch.float32).to(dev)
    img = render_diff(scene.to(dev).with_diff_params(params), camera.to(dev), key,
                      sample_indices, tile_size)
    loss = image_loss(img, tgt)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def scene_and_camera_grads(scene: Scene, camera: Camera, key: torch.Tensor, sample_indices,
                           target, tile_size: int = DEFAULT_TILE, device=None):
    """(loss, (scene grads, camera-pose grads)): the gradients of the five
    scene fields and of the pose fields CAMERA_POSE_FIELDS, the derived
    geometry recomputed from the pose (reinitialize).  Runs on the CUDA
    card unless device says otherwise."""
    dev = resolve_device(device)
    params = _leaves(scene.diff_params(), dev)
    pose = _leaves({f: getattr(camera, f) for f in CAMERA_POSE_FIELDS}, dev)
    cam = reinitialize(camera.to(dev).replace(**pose))
    tgt = torch.as_tensor(target, dtype=torch.float32).to(dev)
    img = render_diff(scene.to(dev).with_diff_params(params), cam, key, sample_indices,
                      tile_size)
    loss = image_loss(img, tgt)
    grads = torch.autograd.grad(loss, list(params.values()) + list(pose.values()))
    n = len(params)
    return loss.detach(), (dict(zip(params, grads[:n])), dict(zip(pose, grads[n:])))


class InverseRenderer:
    """Gradient-descent scene recovery: optimize chosen scene fields so the
    render matches a target image (diff_render.py:117).

        inv = InverseRenderer(scene0, camera, target, fields=("albedo",))
        for step in range(100):
            loss = inv.step()
        recovered = inv.scene

    Adam (torch.optim.Adam, the update of optax.adam: lr, betas (0.9,
    0.999), eps 1e-8) unless optimizer, a function of the parameter list
    returning a torch.optim.Optimizer, is given.  Step i draws from
    fold_in(PRNGKey(seed), i), spp_per_step samples.  engine "scan":
    render_diff; "tape": the host-loop tape tracer (make_tape_tracer with
    key PRNGKey(seed + 1) and pool lanes) on generate_rays of each sample,
    through the fused bounce K10 on the card, the dense closest hit on the
    CPU.  Runs on the CUDA card unless device says otherwise."""

    def __init__(self, scene: Scene, camera: Camera, target, fields: Tuple[str, ...] = (
                 "albedo", "centers"), learning_rate: float = 2e-2, spp_per_step: int = 4,
                 seed: int = 0, tile_size: int = DEFAULT_TILE,
                 optimizer: Optional[Callable] = None, engine: str = "scan", pool: int = 4096,
                 device=None):
        if engine not in ("scan", "tape"):
            raise ValueError(f"unknown engine {engine!r}")
        dev = resolve_device(device)
        self.scene = scene.to(dev)
        self.camera = camera.to(dev)
        self.target = torch.as_tensor(target, dtype=torch.float32).to(dev).reshape(-1, 3)
        self.fields = tuple(fields)
        self.spp = int(spp_per_step)
        self.key = prng.PRNGKey(seed)
        self.tile_size = tile_size
        self._params = _leaves({f: getattr(self.scene, f) for f in self.fields}, dev)
        plist = list(self._params.values())
        self.opt = (optimizer(plist) if optimizer is not None else
                    torch.optim.Adam(plist, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8))
        self._step = 0
        self._render = self._render_scan
        if engine == "tape":
            from distributed_raytracer_tpu_torch.grad.tapegrad import make_tape_tracer

            self._tracer = make_tape_tracer(prng.PRNGKey(seed + 1), camera.max_depth,
                                            pool=pool, use_fused=dev.type == "cuda",
                                            device=dev)
            self._ids = torch.arange(camera.num_pixels, device=dev)
            self._render = self._render_tape

    def _render_scan(self, scene: Scene, key, samples):
        return render_diff(scene, self.camera, key, samples, self.tile_size)

    def _render_tape(self, scene: Scene, key, samples):
        w, ids = self.camera.image_width, self._ids
        acc = 0.0
        for si in samples:
            k_cam, k_trace = prng.split(prng.fold_in(key, si))
            o, d = generate_rays(self.camera, ids % w, ids // w, key=k_cam)
            acc = acc + self._tracer(scene, o, d, k_trace)
        return acc / len(samples)

    def step(self) -> float:
        """One optimizer step on fresh noise; returns the loss before it."""
        k = prng.fold_in(self.key, self._step)
        img = self._render(self.scene.with_diff_params(self._params), k, range(self.spp))
        loss = image_loss(img, self.target)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.scene = self.scene.with_diff_params(
            {f: p.detach().clone() for f, p in self._params.items()})
        self._step += 1
        return float(loss.detach())
