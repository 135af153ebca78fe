"""The dense closest hit as one kernel (K11), and its winner-only gradient.

Port of distributed_raytracer_tpu/ops/pallas/intersect_kernel.py::
closest_hit_pallas (:174; kernel _intersect_kernel :50, pallas_call :141
in _closest_hit_pallas_fwd_impl :117).  Every ray's closest sphere in the
kernel's oc form (c - o first, the half-b quadratic, strict T_MIN, no
t_max), the first index winning a tie; spheres of radius <= 0 are packed
with r^2 = -1, so they never hit.  On CUDA tensors `closest_hit_cuda`
launches the hand-written kernel csrc/intersect.cu; on CPU tensors
`closest_hit_plain` runs the same sweep in plain PyTorch (ops/kernels/
bounce.py's sweep_t and its first-index argmin).

`closest_hit_pallas` is a torch.autograd.Function around either, with
JAX's winner-only backward (_winner_t :157, _bwd :193): the winning
sphere's root is re-derived with [R]-sized tensor code and the sphere
cotangents are summed by index_add_ into n + 1 segments, the misses
going to the dropped one.  The TPU blocking (rays on lanes, sphere chunks
as a grid axis, block_rays and chunk) has no counterpart: a group of
threads per ray sweeps the whole scene (csrc/trace.cuh group_sweep), its
shape read by `group_shape`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from distributed_raytracer_tpu_torch.core import vecmath as vm
from distributed_raytracer_tpu_torch.core.vecmath import BIG, T_MIN
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.intersect import HitResult
from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce import sweep_t
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import _PLAIN_ELEMS


def sphere_pack(centers: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """[N, 4] (cx, cy, cz, r2) on the scene's device, r2 = -1 where the
    radius is not positive (_pack_scene :98)."""
    r2 = torch.where(radii > 0.0, radii * radii, -1.0)
    return torch.cat([centers, r2[:, None]], dim=1).contiguous()


def closest_hit_plain(ray_o: torch.Tensor, ray_d: torch.Tensor, sph: torch.Tensor, *,
                      stats: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [R], idx [R] int32) of every ray against the packed spheres
    sph [N, 4]: the dense sweep, _PLAIN_ELEMS / N rays at a time.  stats,
    when given, gains the ray x sphere tests whose discriminant is not
    negative, as closest_hit_cuda counts them."""
    cols = sph.t()
    step = max(1, _PLAIN_ELEMS // max(1, sph.shape[0]))
    ts, idxs = [], []
    for i in range(0, ray_o.shape[0], step):
        ox, oy, oz = ray_o[i:i + step].unbind(-1)
        dx, dy, dz = ray_d[i:i + step].unbind(-1)
        a = dx * dx + dy * dy + dz * dz
        t, ok = sweep_t(ox, oy, oz, dx, dy, dz, a, 1.0 / a, cols)
        if stats is not None:
            stats[:1] += ok.sum().to(stats.device)
        t_c, idx = torch.min(t, dim=1)  # the first minimum
        ts.append(t_c)
        idxs.append(idx.to(torch.int32))
    return torch.cat(ts), torch.cat(idxs)


def check_rays(ray_o: torch.Tensor, ray_d: torch.Tensor, sph: torch.Tensor) -> int:
    """Check the operands of the closest-hit kernels (CUDA, float32,
    contiguous, one device: ray_o, ray_d [R, 3], sph [N, 4]); returns R."""
    r, dev = ray_o.shape[0], ray_o.device
    for name, x, shape in (("ray_o", ray_o, (r, 3)), ("ray_d", ray_d, (r, 3)),
                           ("sph", sph, (sph.shape[0], 4))):
        if x.device.type != "cuda" or x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name} must be a CUDA float32 tensor on the rays' device")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, got {tuple(x.shape)}")
    if r < 1 or sph.shape[0] < 1:
        raise ValueError("need at least one ray and one sphere")
    return r


def _lib():
    lib = _build.load("intersect")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.closest_hit_launch.argtypes = [p, p, p, i, i, p, p, p]
    lib.closest_hit_launch.restype = i
    return lib


def group_shape() -> Tuple[int, int]:
    """(lanes per ray, threads per block) of the built K11."""
    shape = (ctypes.c_int * 2)()
    _lib().closest_hit_shape(shape)
    return shape[0], shape[1]


def closest_hit_cuda(ray_o: torch.Tensor, ray_d: torch.Tensor, sph: torch.Tensor, *,
                     stats: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K11 (csrc/intersect.cu) on the current stream (no sync); the
    results of closest_hit_plain.  stats, an int64 [1] tensor, gains the
    number of ray x sphere tests whose discriminant is not negative."""
    r = check_rays(ray_o, ray_d, sph)
    if stats is not None and (stats.device != ray_o.device or stats.dtype != torch.int64
                              or stats.numel() < 1):
        raise ValueError("stats must be an int64 tensor on the rays' device")
    t = torch.empty(r, dtype=torch.float32, device=ray_o.device)
    idx = torch.empty(r, dtype=torch.int32, device=ray_o.device)
    err = _lib().closest_hit_launch(
        ray_o.data_ptr(), ray_d.data_ptr(), sph.data_ptr(), sph.shape[0], r, t.data_ptr(),
        idx.data_ptr(), None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(ray_o.device).cuda_stream)
    _build.check(err, "closest_hit_launch")
    closest_hit_cuda.launches += 1
    return t, idx


closest_hit_cuda.launches = 0


def closest_hit_dense(ray_o: torch.Tensor, ray_d: torch.Tensor, sph: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 for CUDA tensors, its plain version for CPU tensors."""
    if ray_o.device.type == "cpu":
        return closest_hit_plain(ray_o, ray_d, sph)
    return closest_hit_cuda(ray_o.contiguous(), ray_d.contiguous(), sph)


def winner_t(ray_o, ray_d, centers_w, radii_w):
    """The chosen root on the winning sphere with [R]-sized math (_winner_t
    :157), differentiable: the surrogate the backward differentiates."""
    oc = centers_w - ray_o
    a = vm.dot(ray_d, ray_d)
    h = vm.dot(ray_d, oc)
    c = vm.dot(oc, oc) - radii_w * radii_w
    disc = h * h - a * c
    safe = torch.where(disc > 0.0, disc, 1.0)
    sqrtd = torch.where(disc > 0.0, torch.sqrt(safe), 0.0)
    root_near = (h - sqrtd) / a
    root_far = (h + sqrtd) / a
    near_ok = (disc >= 0.0) & (root_near > T_MIN)
    return torch.where(near_ok, root_near, root_far)


class WinnerOnlyHit(torch.autograd.Function):
    """A closest hit fwd(ray_o, ray_d, centers, radii) -> (t, idx) whose
    gradient flows through the winner's t alone (the index is piecewise
    constant): JAX's custom VJP of closest_hit_pallas, shared by the
    culled intersects (culled_kernel.py)."""

    @staticmethod
    def forward(ctx, fwd: Callable, ray_o, ray_d, centers, radii):
        t, idx = fwd(ray_o, ray_d, centers, radii)
        hit = t < BIG * 0.5
        ctx.save_for_backward(ray_o, ray_d, centers, radii, idx, hit)
        ctx.mark_non_differentiable(idx, hit)
        return t, idx, hit

    @staticmethod
    def backward(ctx, g_t, _g_idx, _g_hit):
        ray_o, ray_d, centers, radii, idx, hit = ctx.saved_tensors
        dt = torch.where(hit, g_t, 0.0)
        i = idx.long()
        with torch.enable_grad():
            args = [x.detach().requires_grad_() for x in (ray_o, ray_d, centers[i], radii[i])]
            g_o, g_d, g_cw, g_rw = torch.autograd.grad(winner_t(*args), args, dt)
        n = centers.shape[0]
        seg = torch.where(hit, i, n)  # misses go to the dropped segment
        g_c = torch.zeros(n + 1, 3, dtype=centers.dtype, device=centers.device)
        g_r = torch.zeros(n + 1, dtype=radii.dtype, device=radii.device)
        return (None, g_o, g_d, g_c.index_add_(0, seg, g_cw)[:n],
                g_r.index_add_(0, seg, g_rw)[:n])


def _dense_fwd(ray_o, ray_d, centers, radii):
    return closest_hit_dense(ray_o, ray_d, sphere_pack(centers, radii))


def closest_hit_pallas(ray_o: torch.Tensor, ray_d: torch.Tensor, scene: Scene) -> HitResult:
    """Drop-in closest_hit (ops/intersect.py) through K11, differentiable
    in the rays and the scene's centers and radii (winner-only)."""
    t, idx, hit = WinnerOnlyHit.apply(_dense_fwd, ray_o, ray_d, scene.centers, scene.radii)
    return HitResult(t=t, idx=idx, hit=hit)
