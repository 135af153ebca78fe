"""Scene gradients by a recorded tape: the port of the camera tracers of
distributed_raytracer_tpu/grad/tapegrad.py (`make_tape_camera_tracer`
with variant "unified", and `make_tape_camera_walk_tracer` for scenes past
512 spheres) and of their replay oracle `replay_from_tape`.

The forward is a recording forward (ops/kernels/mega_kernel.py, kernel
csrc/mega_forward.cu; or the walk's, ops/kernels/mega_walk_kernel.py,
kernel csrc/mega_walk.cu): colors, and a tape with one row per bounce that
holds the winner's parameters.  The backward walks that tape in reverse
(ops/kernels/mega_walk_bwd_kernel.py, kernel csrc/mega_walk_bwd.cu) and
returns the cotangents of the five differentiable scene fields.  The two
are joined by a torch.autograd.Function.  The camera and the primary rays
are not differentiated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, camera_scalar_row
from distributed_raytracer_tpu_torch.ops.kernels.bounce import scene_sweep_arrays
from distributed_raytracer_tpu_torch.ops.kernels.local_f import local_f_rows
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
    mega_forward_camera,
)
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
                     n_rays: int) -> torch.Tensor:
    """Colors [n_rays, 3] re-computed from a recorded tape with the control
    flow (winner, hit, finish) and the draws frozen and the winner's
    parameters gathered from the scene by the recorded winner index:
    differentiable by autograd in the scene's tensors.  The oracle of the
    backward (tapegrad.py:699-745 with rays_from_tape=True): each ray
    starts from its recorded primary ray at attenuation 1, and each later
    row from the state the replay computed (the backward reads it off the
    tape instead)."""
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
            state = list(rows[:, T_O:T_D + 3].unbind(-1)) + [torch.ones_like(rows[:, 0])] * 3
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
