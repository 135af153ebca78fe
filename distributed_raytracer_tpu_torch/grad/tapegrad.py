"""Gradients by a recorded tape: the port of the tracers of
distributed_raytracer_tpu/grad/tapegrad.py — `make_tape_camera_tracer`
(variant "unified") and `make_tape_camera_walk_tracer` (scenes past 512
spheres) for scene gradients, `make_tape_tracer` (use_mega=True,
mega_bwd=True) for gradients in the scene and the rays, and
`make_tape_camera_pose_tracer` for gradients in the scene and the camera
pose — and of their replay oracle `replay_from_tape`.

The forward is a recording forward (ops/kernels/mega_kernel.py, kernel
csrc/mega_forward.cu in camera or ray mode; or the walk's,
ops/kernels/mega_walk_kernel.py, kernel csrc/mega_walk.cu): colors, and a
tape with one row per bounce that holds the winner's parameters.  The
backward walks that tape in reverse (ops/kernels/mega_walk_bwd_kernel.py,
kernel csrc/mega_walk_bwd.cu, parameters off the tape; or
ops/kernels/mega_bwd_kernel.py, kernel csrc/mega_bwd.cu, parameters from
the scene) and returns the cotangents of the five differentiable scene
fields and, where asked, of each ray's primary origin and direction.  The
two are joined by a torch.autograd.Function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import CAM_ROW, Camera, camera_scalar_row
from distributed_raytracer_tpu_torch.ops.kernels.bounce import scene_sweep_arrays
from distributed_raytracer_tpu_torch.ops.kernels.local_f import local_f_rows
from distributed_raytracer_tpu_torch.ops.kernels.mega_bwd_kernel import mega_backward
from distributed_raytracer_tpu_torch.ops.kernels.mega_kernel import (
    F_ACT,
    F_FIN,
    F_HIT,
    T_D,
    T_FLG,
    T_IDX,
    T_MT,
    T_O,
    T_RU,
    T_U,
    mega_forward,
    mega_forward_camera,
)
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import camera_rays_host
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_bwd_kernel import (
    N_PARAMS,
    int_col,
    mega_walk_backward,
)
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_kernel import (
    mega_walk_forward_camera,
    walk_pack_arrays_from_scene,
    walk_pack_for,
)


def replay_from_tape(scene: Scene, tape: torch.Tensor, lengths: torch.Tensor,
                     n_rays: int, ray_o: Optional[torch.Tensor] = None,
                     ray_d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Colors [n_rays, 3] re-computed from a recorded tape with the control
    flow (winner, hit, finish) and the draws frozen and the winner's
    parameters gathered from the scene by the recorded winner index:
    differentiable by autograd in the scene's tensors.  The oracle of the
    backwards (tapegrad.py:699-745): each ray starts at attenuation 1 from
    its recorded primary ray (rays_from_tape=True there) or, given ray_o
    and ray_d [n_rays, 3], from those (rays_from_tape=False), so the
    colors are differentiable in the rays too; each later row starts from
    the state the replay computed (the backward reads it off the tape
    instead)."""
    if (ray_o is None) != (ray_d is None):
        raise ValueError("pass both ray_o and ray_d, or neither")
    if lengths.shape != (n_rays,):
        raise ValueError(f"lengths must be [{n_rays}], got {tuple(lengths.shape)}")
    colors = torch.zeros(n_rays, 3, dtype=torch.float32, device=tape.device)
    lens = lengths.to(torch.int64)
    rays = torch.nonzero(lens > 0).squeeze(1)
    state = None
    for depth in range(tape.shape[0]):
        if depth > 0:
            keep = lens[rays] > depth
            rays = rays[keep]
            state = [s[keep] for s in state]
        if rays.numel() == 0:
            break
        rows = tape[depth, rays]
        if depth == 0:
            od = rows[:, T_O:T_D + 3] if ray_o is None else torch.cat([ray_o[rays], ray_d[rays]], 1)
            state = list(od.unbind(-1)) + [torch.ones_like(rows[:, 0])] * 3
        flags = int_col(rows, T_FLG)
        fin = (flags & F_FIN) != 0
        # a row that hit nothing gathers sphere 0; local_f_rows guards its
        # radius and ior, and none of its outputs depend on them
        idx = int_col(rows, T_IDX).to(torch.int64)
        c, al = scene.centers[idx], scene.albedo[idx]
        out = local_f_rows(*state, c[:, 0], c[:, 1], c[:, 2], scene.radii[idx],
                           al[:, 0], al[:, 1], al[:, 2], scene.fuzz[idx], scene.ior[idx],
                           rows[:, T_MT], rows[:, T_RU], rows[:, T_RU + 1], rows[:, T_RU + 2],
                           rows[:, T_U], (flags & F_HIT) != 0, (flags & F_ACT) != 0)
        colors = colors.index_add(0, rays[fin], torch.stack(out[9:12], -1)[fin])
        state = list(out[0:9])
    return colors


class _TapeCameraTrace(torch.autograd.Function):
    """colors = trace(centers, radii, albedo, fuzz, ior); the backward is
    the reverse tape walk."""

    @staticmethod
    def forward(ctx, centers, radii, albedo, fuzz, ior, mat_type, pixel_ids, cam_row, kw):
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        cols, attrs = scene_sweep_arrays(scene)
        out = mega_forward_camera(cols, attrs, cam_row, pixel_ids, **kw)
        ctx.save_for_backward(out.tape, out.lengths)
        ctx.n = centers.shape[0]
        return out.colors

    @staticmethod
    def backward(ctx, g_color):
        tape, lengths = ctx.saved_tensors
        n = ctx.n
        g_pm = mega_walk_backward(tape, lengths, g_color.contiguous(), n)
        return (g_pm[:n, 0:3], g_pm[:n, 3], g_pm[:n, 4:7], g_pm[:n, 7], g_pm[:n, 8],
                None, None, None, None)


def make_tape_camera_tracer(camera: Camera, bounce_seed: int, cam_seed: int, *,
                            max_depth: Optional[int] = None, iota_pix: bool = False,
                            device=None):
    """The scene-gradient tracer with in-kernel camera rays:
    tracer(scene, pixel_ids [R], pix0=None) -> colors [R, 3], differentiable
    in scene.centers, radii, albedo, fuzz and ior.

    The two int32 seeds take the place of the JAX key: bounce draws are
    keyed (pixel, bounce_seed + depth * 65537), camera draws (pixel,
    cam_seed).  iota_pix: the pixels are pix0 + 0..R-1 and pixel_ids
    gives only R (the full-image and contiguous-shard shape); otherwise
    the pixels are pixel_ids, and pix0 is refused.  Runs on the CUDA card
    unless device says otherwise; the scene is moved to that device (a
    differentiable move)."""
    dev = resolve_device(device)
    cam_row = camera_scalar_row(camera).to(dev).contiguous()
    depth = camera.max_depth if max_depth is None else int(max_depth)

    def tracer(scene: Scene, pixel_ids: torch.Tensor, pix0: Optional[int] = None):
        if pix0 is not None and not iota_pix:
            # a table-mode caller passing a shard offset would silently get
            # the wrong pixels
            raise ValueError("pix0 requires iota_pix=True (table mode derives pixels "
                             "from pixel_ids alone; add the offset to pixel_ids)")
        s = scene.to(dev)
        ids = None if iota_pix else pixel_ids.to(device=dev, dtype=torch.int32).contiguous()
        kw = dict(bounce_seed=int(bounce_seed), cam_seed=int(cam_seed), pix0=int(pix0 or 0),
                  n_valid=int(pixel_ids.shape[0]), w=camera.image_width, max_depth=depth)
        return _TapeCameraTrace.apply(s.centers, s.radii, s.albedo, s.fuzz, s.ior, s.mat_type,
                                      ids, cam_row, kw)

    return tracer


class _TapeRayTrace(torch.autograd.Function):
    """colors = trace(centers, radii, albedo, fuzz, ior, ray_o, ray_d);
    the backward is the dense reverse walk with parameters from the
    scene (K7)."""

    @staticmethod
    def forward(ctx, centers, radii, albedo, fuzz, ior, mat_type, ray_o, ray_d, ray_grads, kw):
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        cols, attrs = scene_sweep_arrays(scene)
        out = mega_forward(cols, attrs, ray_o.contiguous(), ray_d.contiguous(), **kw)
        ctx.save_for_backward(cols, attrs, out.tape, out.lengths)
        ctx.ray_grads = ray_grads
        return out.colors

    @staticmethod
    def backward(ctx, g_color):
        cols, attrs, tape, lengths = ctx.saved_tensors
        n = cols.shape[1]
        want_rays = ctx.ray_grads and (ctx.needs_input_grad[6] or ctx.needs_input_grad[7])
        out = mega_backward(cols, attrs, tape, lengths, g_color.contiguous(), n,
                            ray_grads=want_rays)
        g_pm = out[0] if want_rays else out
        g_o = g_d = None
        if ctx.needs_input_grad[6] or ctx.needs_input_grad[7]:
            # ray_grads=False: zeros, as the JAX tracer documents
            g_ray = out[1] if want_rays else g_color.new_zeros(lengths.shape[0], 6)
            g_o, g_d = g_ray[:, 0:3], g_ray[:, 3:6]
        return (g_pm[:n, 0:3], g_pm[:n, 3], g_pm[:n, 4:7], g_pm[:n, 7], g_pm[:n, 8],
                None, g_o, g_d, None, None)


def make_tape_tracer(bounce_seed: int, max_depth: int, *, ray_grads: bool = True, device=None):
    """The tracer of given rays (tapegrad.py:1273 with use_mega=True,
    mega_bwd=True): tracer(scene, ray_o [R, 3], ray_d [R, 3]) -> colors
    [R, 3], differentiable in scene.centers, radii, albedo, fuzz and ior
    and in ray_o and ray_d.  The forward is the recording forward in ray
    mode (K6), the backward the dense reverse walk (K7).

    bounce_seed (an int32 seed in place of the JAX key) keys ray i's
    bounce draws (i, bounce_seed + depth * 65537).  ray_grads=False: the
    backward skips the primary-ray cotangents, and ray_o and ray_d get
    zero gradients (the scene-only shape; JAX documents the same).  The
    TPU scheduling knobs of the JAX tracer (pool, budget, block_rays,
    mega_pad, segsum, use_fused, planar, refill_every, loop_unroll, the
    NaN-poisoned clean flag) have no counterpart.  Runs on the CUDA card
    unless device says otherwise; scene and rays are moved to that device
    (differentiable moves)."""
    dev = resolve_device(device)
    kw = dict(bounce_seed=int(bounce_seed), max_depth=int(max_depth))

    def tracer(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
        if ray_o.dim() != 2 or ray_o.shape[1] != 3 or ray_d.shape != ray_o.shape:
            raise ValueError(f"ray_o and ray_d must be [R, 3], got {tuple(ray_o.shape)} and "
                             f"{tuple(ray_d.shape)}")
        s = scene.to(dev)
        f32 = dict(device=dev, dtype=torch.float32)
        return _TapeRayTrace.apply(s.centers, s.radii, s.albedo, s.fuzz, s.ior, s.mat_type,
                                   ray_o.to(**f32), ray_d.to(**f32), bool(ray_grads), kw)

    return tracer


class _TapeCameraPoseTrace(torch.autograd.Function):
    """colors = trace(centers, radii, albedo, fuzz, ior, cam_row); the
    backward is the reverse walk with ray grads (K8), then the VJP of
    camera_rays_host into the camera row."""

    @staticmethod
    def forward(ctx, centers, radii, albedo, fuzz, ior, mat_type, cam_row, kw):
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        cols, attrs = scene_sweep_arrays(scene)
        out = mega_forward_camera(cols, attrs, cam_row.contiguous(), None, **kw)
        ctx.save_for_backward(out.tape, out.lengths, cam_row)
        ctx.n = centers.shape[0]
        ctx.kw = kw
        return out.colors

    @staticmethod
    def backward(ctx, g_color):
        tape, lengths, cam_row = ctx.saved_tensors
        n, kw = ctx.n, ctx.kw
        g_pm, g_ray = mega_walk_backward(tape, lengths, g_color.contiguous(), n, ray_grads=True)
        g_cam = None
        if ctx.needs_input_grad[6]:
            pix = torch.arange(kw["n_valid"], dtype=torch.int64, device=cam_row.device)
            with torch.enable_grad():
                cr = cam_row.detach().requires_grad_()
                o, d = camera_rays_host(cr, pix, pix, kw["cam_seed"], kw["w"])
                (g_cam,) = torch.autograd.grad([o, d], [cr], [g_ray[:, 0:3], g_ray[:, 3:6]])
        return (g_pm[:n, 0:3], g_pm[:n, 3], g_pm[:n, 4:7], g_pm[:n, 7], g_pm[:n, 8],
                None, g_cam, None)


def make_tape_camera_pose_tracer(camera: Camera, bounce_seed: int, cam_seed: int, *,
                                 max_depth: Optional[int] = None, device=None):
    """Camera-pose gradients (tapegrad.py:1012): tracer(scene, cam_row
    [24]) -> colors [n_pix, 3] of the whole image, differentiable in
    scene.centers, radii, albedo, fuzz and ior and in the camera row
    (center, pixel00, pixel deltas, defocus disk).  Pass cam_row =
    camera_scalar_row(camera) of a camera whose pose fields carry
    gradients (ops/camera.py::derive of tensors that require grad) and
    autograd chains the row's cotangents to the pose.  camera gives the
    shape (width, height, depth); its values are superseded by cam_row.

    The forward is the recording forward in camera mode (K6) on the
    pixels 0..n_pix-1, so at equal seeds the colors equal
    make_tape_camera_tracer(..., iota_pix=True)'s bit for bit.  The
    backward is the reverse walk with ray grads (K8): the cotangents of
    each pixel's primary ray at its first row (depth 0 on the port's
    per-ray tape, so JAX's camera_pos_from_tape has no counterpart),
    pushed through torch.autograd of camera_rays_host (the rays the
    kernel makes, as a differentiable function of cam_row).  Runs on the
    CUDA card unless device says otherwise."""
    dev = resolve_device(device)
    kw = dict(bounce_seed=int(bounce_seed), cam_seed=int(cam_seed), pix0=0,
              n_valid=camera.num_pixels, w=camera.image_width,
              max_depth=camera.max_depth if max_depth is None else int(max_depth))

    def tracer(scene: Scene, cam_row: torch.Tensor) -> torch.Tensor:
        if tuple(cam_row.shape) != (CAM_ROW,):
            raise ValueError(f"cam_row must be [{CAM_ROW}], got {tuple(cam_row.shape)}")
        s = scene.to(dev)
        return _TapeCameraPoseTrace.apply(s.centers, s.radii, s.albedo, s.fuzz, s.ior,
                                          s.mat_type, cam_row.to(device=dev,
                                                                 dtype=torch.float32), kw)

    return tracer


class _TapeCameraWalkTrace(torch.autograd.Function):
    """colors = walk trace(centers, radii, albedo, fuzz, ior); the backward
    is the reverse tape walk over the pack's slots, mapped back to the
    original spheres."""

    @staticmethod
    def forward(ctx, centers, radii, albedo, fuzz, ior, mat_type, walk, kw):
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        scene_pack, attrs, _ = walk_pack_arrays_from_scene(scene, walk["slot_to_orig"],
                                                           walk["chunk"])
        out = mega_walk_forward_camera(scene_pack, attrs, walk["bounds"], walk["chunk_len"],
                                       walk["cam_row"], **kw)
        ctx.save_for_backward(out.tape, out.lengths)
        ctx.walk = walk
        return out.colors

    @staticmethod
    def backward(ctx, g_color):
        tape, lengths = ctx.saved_tensors
        inv = ctx.walk["orig_to_slot"]
        n_slots = ctx.walk["slot_to_orig"].shape[0]
        g_pm = mega_walk_backward(tape, lengths, g_color.contiguous(), n_slots)
        # per slot -> per original sphere: the no-hit bin (row n_slots) is
        # replaced by a zero row, which the spheres absent from the pack get
        g_full = torch.cat([g_pm[:n_slots], g_pm.new_zeros(1, N_PARAMS)])
        g = g_full[inv]
        return g[:, 0:3], g[:, 3], g[:, 4:7], g[:, 7], g[:, 8], None, None, None


def make_tape_camera_walk_tracer(camera: Camera, bounce_seed: int, cam_seed: int,
                                 scene0: Scene, *, chunk: int = 256,
                                 max_depth: Optional[int] = None, bound_slack: float = 0.0,
                                 device=None):
    """The scene-gradient tracer for scenes of any size, on the walk
    (tapegrad.py:1136-1270): tracer(scene, pixel_ids [R], pix0=None) ->
    colors [R, 3], differentiable in scene.centers, radii, albedo, fuzz
    and ior; at equal seeds its colors are the walk render's (sample 0)
    bit for bit.

    The pixels are pix0 + 0..R-1, and pixel_ids must hold exactly those
    ids (the JAX tracer reads only their count; this one raises on other
    ids rather than render pixels the caller did not name).  scene0 is the
    reference scene the pack's skeleton is built from, once, on the host:
    the Morton chunks, their bounds and the camera's visit order.  Each
    call gathers the traced scene's values into that slot order, so
    gradients flow and parameter updates take effect, but the bounds stay
    scene0's: geometry that moves out of its chunk's bound can be culled.
    bound_slack widens every finite bound radius by that much; albedo,
    fuzz and ior never invalidate the bounds.  Spheres absent from the
    pack (radius <= 0 in scene0) get zero gradients.  Runs on the CUDA
    card unless device says otherwise."""
    dev = resolve_device(device)
    pack = walk_pack_for(scene0, camera, chunk=chunk)
    sto = pack.slot_to_orig
    n_slots = sto.shape[0]
    inv = np.full(scene0.num_spheres, n_slots, np.int64)
    live = sto >= 0
    inv[sto[live]] = np.nonzero(live)[0]
    bounds = pack.bounds.numpy().copy()
    if bound_slack:
        finite = bounds[:, 3] > 0.0
        bounds[finite, 3] = (np.sqrt(bounds[finite, 3]) + np.float32(bound_slack)) ** 2
    walk = dict(slot_to_orig=torch.from_numpy(sto).to(dev), chunk=chunk,
                orig_to_slot=torch.from_numpy(inv).to(dev),
                bounds=torch.from_numpy(bounds).to(dev), chunk_len=pack.chunk_len.to(dev),
                cam_row=camera_scalar_row(camera).to(dev).contiguous())
    depth = camera.max_depth if max_depth is None else int(max_depth)

    def tracer(scene: Scene, pixel_ids: torch.Tensor, pix0: Optional[int] = None):
        if scene.num_spheres != scene0.num_spheres:
            raise ValueError(f"the tracer was built for {scene0.num_spheres} spheres, got "
                             f"{scene.num_spheres}")
        r = int(pixel_ids.shape[0])
        p0 = int(pix0 or 0)
        want = torch.arange(p0, p0 + r, device=pixel_ids.device)
        if not torch.equal(pixel_ids.to(torch.int64), want):
            raise ValueError("the walk tracer renders pixels pix0 + 0..R-1: pixel_ids must be "
                             "exactly those ids")
        s = scene.to(dev)
        kw = dict(bounce_seed=int(bounce_seed), cam_seed=int(cam_seed), pix0=p0, n_valid=r,
                  w=camera.image_width, max_depth=depth)
        return _TapeCameraWalkTrace.apply(s.centers, s.radii, s.albedo, s.fuzz, s.ior,
                                          s.mat_type, walk, kw)

    return tracer
