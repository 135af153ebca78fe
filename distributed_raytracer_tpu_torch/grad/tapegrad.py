"""Gradients by a recorded tape: the port of the tracers of
distributed_raytracer_tpu/grad/tapegrad.py — `make_tape_camera_tracer`
(variant "unified") and `make_tape_camera_walk_tracer` (scenes past 512
spheres) for scene gradients, `make_tape_tracer` for gradients in the
scene and the rays, and `make_tape_camera_pose_tracer` for gradients in
the scene and the camera pose — and of their replay oracles.

The kernel tracers' forward is a recording forward (ops/kernels/
mega_kernel.py, kernel csrc/mega_forward.cu in camera or ray mode; or the
walk's, ops/kernels/mega_walk_kernel.py, kernel csrc/mega_walk.cu):
colors, and a tape with one row per bounce that holds the winner's
parameters.  The backward walks that tape in reverse (ops/kernels/
mega_walk_bwd_kernel.py, kernel csrc/mega_walk_bwd.cu, parameters off the
tape; or ops/kernels/mega_bwd_kernel.py, kernel csrc/mega_bwd.cu,
parameters from the scene) and returns the cotangents of the five
differentiable scene fields and, where asked, of each ray's primary
origin and direction.  `replay_from_tape` is their oracle.

`make_tape_tracer(use_mega=False)` is the host-loop tracer
(tapegrad.py:139-342, 473-745): `_forward_tape` runs a pool of lanes on
the host, one Python iteration per pool row, each row bouncing every lane
through an intersect (the dense closest hit, K11, or K12/K13) and the
local bounce with threefry draws, or through the fused bounce K10, and
records a `_Tape` in JAX's packed column layout (a JAX tape converts by
`_Tape.from_numpy`); `_backward_tape` walks it in reverse with autograd of
the local bounce per row; `replay_pool_tape` is its oracle.  Each tracer
joins forward and backward in a torch.autograd.Function.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.grad.pathgrad import (
    _draws,
    _gather_params,
    _local_bounce,
    local_vjp,
)
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import CAM_ROW, Camera, camera_scalar_row
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit
from distributed_raytracer_tpu_torch.ops.kernels.bounce import scene_sweep_arrays
from distributed_raytracer_tpu_torch.ops.kernels.bounce_kernel import (
    fused_bounce,
    fused_scene_arrays,
)
from distributed_raytracer_tpu_torch.ops.kernels.local_f import local_f_rows
from distributed_raytracer_tpu_torch.ops.kernels.mega_bwd_kernel import (
    mega_backward,
    mega_backward_plain,
)
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


# ---- the host-loop tape tracer (tapegrad.py:58-342, 473-745) ----


class _Tape(NamedTuple):
    """The host-loop forward's tape: one row of B lanes per pool
    iteration, in JAX's packed column layout, so that a JAX tape converts
    by from_numpy.

    fdata columns: o (0:3), d (3:6), atten (6:9), ruv (9:12), u (12),
    contrib (13:16); idata columns: idx (0), lane_ray (1), flags (2) =
    hit | live << 1 | take << 2 | finished << 3.  contrib is the terminal
    color a lane that finished emitted in that row."""

    fdata: torch.Tensor  # [T, B, 16] float
    idata: torch.Tensor  # [T, B, 3] int32

    @classmethod
    def from_numpy(cls, fdata: np.ndarray, idata: np.ndarray, device="cpu") -> "_Tape":
        """A tape from its two arrays as numpy (e.g. np.asarray of a JAX
        _Tape's fields)."""
        return cls(fdata=torch.from_numpy(np.array(fdata, np.float32)).to(device),
                   idata=torch.from_numpy(np.array(idata, np.int32)).to(device))


class _Rec(NamedTuple):
    """One unpacked tape row, [B, ...]."""

    o: torch.Tensor
    d: torch.Tensor
    atten: torch.Tensor
    idx: torch.Tensor
    lane_ray: torch.Tensor
    hit: torch.Tensor
    live: torch.Tensor
    take: torch.Tensor
    finished: torch.Tensor
    ruv: torch.Tensor
    u: torch.Tensor
    contrib: torch.Tensor


def _pack_rec(rec: _Rec):
    f = torch.cat([rec.o, rec.d, rec.atten, rec.ruv, rec.u[:, None], rec.contrib], dim=-1)
    flags = (rec.hit.to(torch.int32) | (rec.live.to(torch.int32) << 1)
             | (rec.take.to(torch.int32) << 2) | (rec.finished.to(torch.int32) << 3))
    i = torch.stack([rec.idx.to(torch.int32), rec.lane_ray.to(torch.int32), flags], dim=-1)
    return f, i


def _unpack_rec(f: torch.Tensor, i: torch.Tensor) -> _Rec:
    flags = i[:, 2]
    return _Rec(o=f[:, 0:3], d=f[:, 3:6], atten=f[:, 6:9], ruv=f[:, 9:12], u=f[:, 12],
                idx=i[:, 0], lane_ray=i[:, 1], hit=(flags & 1) != 0, live=(flags & 2) != 0,
                take=(flags & 4) != 0, finished=(flags & 8) != 0, contrib=f[:, 13:16])


def tape_budget(n_rays: int, max_depth: int, pool: int, refill_every: int = 1) -> int:
    """Worst-case tape rows (tapegrad.py:124): every ray to max_depth, a
    lane idling up to refill_every - 1 rows after it finishes mid-block,
    the drain tail, rounded up to a multiple of refill_every."""
    k = refill_every
    base = -(-n_rays * (max_depth + k - 1) // pool)
    raw = base + max_depth + 2 * k + 2
    return -(-raw // k) * k


def _forward_tape(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor, key: torch.Tensor,
                  max_depth: int, pool: int, intersect_fn=closest_hit, use_fused: bool = False,
                  budget: Optional[int] = None, refill_every: int = 1):
    """The recording forward of the host-loop tracer (tapegrad.py:139):
    returns (colors [R, 3], _Tape, n_it, pos [R]).

    A pool of B = min(pool, R) lanes; every block of refill_every rows the
    free lanes take the next rays by cumsum rank (read through a B-row
    window of the ray table at the emitted count), then each row bounces
    every lane once: intersect_fn and the local bounce with the draws of
    split(fold_in(key, row), B) by lane, or use_fused's K10 (seed
    randint(key) + row * 65537, the lane's ray keying the draws).  A lane
    that finishes mid-block idles until the block ends (live=False rows).
    pos holds each ray's flat tape position (row * B + lane) where it
    finished, -1 for a ray that ran out of depth (black).  The loop stops
    at the budget (default tape_budget's worst case); if rays were left
    then, every color is NaN, loudly (tapegrad.py:326-342)."""
    r, dev, ft = ray_o.shape[0], ray_o.device, ray_o.dtype
    b = min(pool, r)
    k_sub = max(1, refill_every)
    t_budget = budget if budget is not None else tape_budget(r, max_depth, b, k_sub)
    if use_fused:
        seed_base = prng.bounce_seed(key)
        arrays = fused_scene_arrays(scene)
    # rays padded by B rows, so the refill window never runs off the end
    pad = torch.zeros(b, 3, dtype=ft, device=dev)
    ray_o_w, ray_d_w = torch.cat([ray_o, pad]), torch.cat([ray_d, pad])
    tape = _Tape(fdata=torch.zeros(t_budget, b, 16, dtype=ft, device=dev),
                 idata=torch.zeros(t_budget, b, 3, dtype=torch.int32, device=dev))
    o = torch.zeros(b, 3, dtype=ft, device=dev)
    d = torch.ones(b, 3, dtype=ft, device=dev)  # nonzero before the first refill
    atten = torch.ones(b, 3, dtype=ft, device=dev)
    lane_ray = torch.zeros(b, dtype=torch.int64, device=dev)
    lane_depth = torch.zeros(b, dtype=torch.int64, device=dev)
    live = torch.zeros(b, dtype=torch.bool, device=dev)
    lane_iota = torch.arange(b, device=dev)
    pos = torch.full((r + 1,), -1, dtype=torch.int64, device=dev)  # row r: dropped
    zero_c = torch.zeros(b, 3, dtype=ft, device=dev)
    emitted, it, any_live = 0, 0, False
    while (emitted < r or any_live) and it + k_sub <= t_budget:
        free = ~live
        rank = torch.cumsum(free, 0) - 1
        take = free & (rank < r - emitted)
        nr = torch.clamp(emitted + torch.where(take, rank, 0), 0, r - 1)
        rk = torch.clamp(torch.where(take, rank, 0), 0, b - 1)
        tk = take[:, None]
        o = torch.where(tk, ray_o_w[emitted:emitted + b][rk], o)
        d = torch.where(tk, ray_d_w[emitted:emitted + b][rk], d)
        atten = torch.where(tk, 1.0, atten)
        lane_ray = torch.where(take, nr, lane_ray)
        lane_depth = torch.where(take, 0, lane_depth)
        live = live | take
        emitted += min(int(free.sum()), r - emitted)

        fin_flat = torch.full((b,), -1, dtype=torch.int64, device=dev)
        for s in range(k_sub):
            row = it + s
            if use_fused:
                res = fused_bounce(o.contiguous(), d.contiguous(), live,
                                   lane_ray.to(torch.int32), arrays, seed_base + row * 65537)
                hit = res.hit & live
                idx, ruv, u = res.idx, res.ruv, res.u
                fin = (res.finished == 1) & live
                keep = live & ~fin
                # the kernel emits the merged next ray and an attenuation of
                # exactly 1 where the lane did not scatter
                o2, d2, atten2 = res.new_o, res.new_d, atten * res.atten
                contrib = atten * res.color
            else:
                res = intersect_fn(o, d, scene)
                hit = res.hit & live
                idx = res.idx
                params = _gather_params(scene, idx, hit)
                ruv, u = _draws(prng.split_keys(prng.keys_of(prng.fold_in(key, row), dev),
                                                b)[0])
                ruv, u = ruv.to(ft), u.to(ft)
                o2, d2, atten2, contrib, keep = _local_bounce(o, d, atten, zero_c, params, ruv,
                                                              u, hit, live)
                fin = live & ~keep
            lane_depth = lane_depth + live.to(torch.int64)
            rec_f, rec_i = _pack_rec(_Rec(o=o, d=d, atten=atten, idx=idx, lane_ray=lane_ray,
                                          hit=hit, live=live, take=take, finished=fin, ruv=ruv,
                                          u=u, contrib=contrib))
            tape.fdata[row] = rec_f
            tape.idata[row] = rec_i
            # a lane finishes at most once a block (no refill mid-block)
            fin_flat = torch.where(fin, row * b + lane_iota, fin_flat)
            o, d, atten = o2, d2, atten2
            live = keep & (lane_depth < max_depth)
            take = torch.zeros_like(take)  # only a block's first row refills
        # the drain: where each ray finished (the colors stay on the tape)
        pos[torch.where(fin_flat >= 0, lane_ray, r)] = fin_flat
        it += k_sub
        any_live = bool(live.any())
    truncated = emitted < r or any_live
    flat_contrib = tape.fdata[:, :, 13:16].reshape(t_budget * b, 3)
    if truncated:
        flat_contrib = torch.full_like(flat_contrib, float("nan"))
    pos = pos[:r]
    color = torch.where((pos >= 0)[:, None],
                        flat_contrib[torch.clamp(pos, 0, t_budget * b - 1)], 0.0)
    return color, tape, it, pos


def _backward_tape(scene: Scene, tape: _Tape, n_it: int, pos: torch.Tensor,
                   g_color: torch.Tensor, ray_grads: bool = True):
    """The reverse walk of the host-loop tape (tapegrad.py:483): rows
    n_it - 1 .. 0; a lane's cotangent at row it flows from the same lane at
    it + 1, the color cotangent of a ray enters at its finish position, a
    lane refilled at row it emits its ray's primary cotangents and cuts its
    carry.  The per-row VJP is autograd of the local bounce; the sphere
    cotangents are one index_add_ of [B, 9] into [n + 1, 9] a row (misses
    to the dropped segment n).  Returns (dict of the five fields'
    cotangents, g_ray_o [R, 3], g_ray_d [R, 3]); zeros for the rays
    without ray_grads."""
    r, dev, ft = g_color.shape[0], g_color.device, tape.fdata.dtype
    t_budget, b = tape.fdata.shape[:2]
    n = scene.num_spheres
    flatn = t_budget * b
    gc_flat = torch.zeros(flatn + 1, 3, dtype=ft, device=dev)  # row flatn: dropped
    gc_flat[torch.where(pos >= 0, pos, flatn)] = g_color.to(ft)
    cot = [torch.zeros(b, 3, dtype=ft, device=dev) for _ in range(3)]  # o, d, atten
    g_pm = torch.zeros(n + 1, 9, dtype=ft, device=dev)
    g_ray = [torch.zeros(r + 1, 3, dtype=ft, device=dev) for _ in range(2)]  # row r: dropped
    zero_c = torch.zeros(b, 3, dtype=ft, device=dev)
    for it in range(int(n_it) - 1, -1, -1):
        rec = _unpack_rec(tape.fdata[it], tape.idata[it])
        cot_c = gc_flat[it * b:(it + 1) * b]
        params = _gather_params(scene, torch.clamp(rec.idx.to(torch.int64), 0, n - 1), rec.hit)
        d_o, d_d, d_at, _, d_cw, d_rw, d_aw, d_fw, d_iw = local_vjp(
            rec.o, rec.d, rec.atten, zero_c, params, rec.ruv, rec.u, rec.hit, rec.live,
            cot + [cot_c])
        seg = torch.where(rec.hit, rec.idx.to(torch.int64), n)
        g_pm.index_add_(0, seg, torch.cat([d_cw, d_rw[:, None], d_aw, d_fw[:, None],
                                           d_iw[:, None]], dim=-1))
        tk = rec.take[:, None]
        if ray_grads:
            slot = torch.where(rec.take, rec.lane_ray.to(torch.int64), r)
            g_ray[0][slot] = d_o
            g_ray[1][slot] = d_d
        cot = [torch.where(tk, 0.0, x) for x in (d_o, d_d, d_at)]
    fields = dict(centers=g_pm[:n, 0:3], radii=g_pm[:n, 3], albedo=g_pm[:n, 4:7],
                  fuzz=g_pm[:n, 7], ior=g_pm[:n, 8])
    return fields, g_ray[0][:r], g_ray[1][:r]


def replay_pool_tape(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor, tape: _Tape,
                     n_iters: int, rays_from_tape: bool = False) -> torch.Tensor:
    """Colors [R, 3] re-computed from a host-loop tape with the control
    flow (take, idx, hit, live, finished) and the draws frozen,
    differentiable by autograd in the scene and the rays: the oracle of
    _backward_tape (JAX's replay_from_tape, tapegrad.py:699).
    rays_from_tape=True takes a refilled lane's ray from the tape instead
    of ray_o, ray_d (only their row count is read)."""
    r = ray_o.shape[0]
    b = tape.fdata.shape[1]
    ft = tape.fdata.dtype
    dev = tape.fdata.device
    o = torch.zeros(b, 3, dtype=ft, device=dev)
    d = torch.ones(b, 3, dtype=ft, device=dev)
    atten = torch.ones(b, 3, dtype=ft, device=dev)
    out = torch.zeros(r + 1, 3, dtype=ft, device=dev)  # row r: dropped
    zero_c = torch.zeros(b, 3, dtype=ft, device=dev)
    for it in range(int(n_iters)):
        rec = _unpack_rec(tape.fdata[it], tape.idata[it])
        tk = rec.take[:, None]
        if rays_from_tape:
            o, d = torch.where(tk, rec.o, o), torch.where(tk, rec.d, d)
        else:
            nr = torch.clamp(rec.lane_ray.to(torch.int64), 0, r - 1)
            o, d = torch.where(tk, ray_o[nr], o), torch.where(tk, ray_d[nr], d)
        atten = torch.where(tk, 1.0, atten)
        params = _gather_params(scene, rec.idx, rec.hit)
        o, d, atten, contrib = _local_bounce(o, d, atten, zero_c, params, rec.ruv, rec.u,
                                             rec.hit, rec.live)[:4]
        slot = torch.where(rec.finished, rec.lane_ray.to(torch.int64), r)
        out = out.index_put((slot,), contrib)
    return out[:r]


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
    scene: K7 on the card (mega_bwd), or its plain tensor-code walk
    (JAX's XLA backward of the mega tape)."""

    @staticmethod
    def forward(ctx, centers, radii, albedo, fuzz, ior, mat_type, ray_o, ray_d, ray_grads, kw,
                mega_bwd):
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        cols, attrs = scene_sweep_arrays(scene)
        out = mega_forward(cols, attrs, ray_o.contiguous(), ray_d.contiguous(), **kw)
        ctx.save_for_backward(cols, attrs, out.tape, out.lengths)
        ctx.ray_grads, ctx.mega_bwd = ray_grads, mega_bwd
        return out.colors

    @staticmethod
    def backward(ctx, g_color):
        cols, attrs, tape, lengths = ctx.saved_tensors
        n = cols.shape[1]
        want_rays = ctx.ray_grads and (ctx.needs_input_grad[6] or ctx.needs_input_grad[7])
        walk = mega_backward if ctx.mega_bwd else mega_backward_plain
        out = walk(cols, attrs, tape, lengths, g_color.contiguous(), n, ray_grads=want_rays)
        g_pm = out[0] if want_rays else out
        g_o = g_d = None
        if ctx.needs_input_grad[6] or ctx.needs_input_grad[7]:
            # ray_grads=False: zeros, as the JAX tracer documents
            g_ray = out[1] if want_rays else g_color.new_zeros(lengths.shape[0], 6)
            g_o, g_d = g_ray[:, 0:3], g_ray[:, 3:6]
        return (g_pm[:n, 0:3], g_pm[:n, 3], g_pm[:n, 4:7], g_pm[:n, 7], g_pm[:n, 8],
                None, g_o, g_d, None, None, None)


class _TapeHostTrace(torch.autograd.Function):
    """colors = trace(centers, radii, albedo, fuzz, ior, ray_o, ray_d) on
    the host-loop recording forward; the backward walks its pool tape in
    reverse (_backward_tape)."""

    @staticmethod
    def forward(ctx, centers, radii, albedo, fuzz, ior, mat_type, ray_o, ray_d, k, cfg):
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        color, tape, n_it, pos = _forward_tape(scene, ray_o, ray_d, k, **cfg["fwd"])
        ctx.save_for_backward(centers, radii, albedo, fuzz, ior, mat_type, tape.fdata,
                              tape.idata, pos)
        ctx.n_it, ctx.ray_grads = n_it, cfg["ray_grads"]
        return color

    @staticmethod
    def backward(ctx, g_color):
        centers, radii, albedo, fuzz, ior, mat_type, fdata, idata, pos = ctx.saved_tensors
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        want_rays = ctx.ray_grads and (ctx.needs_input_grad[6] or ctx.needs_input_grad[7])
        g, g_o, g_d = _backward_tape(scene, _Tape(fdata=fdata, idata=idata), ctx.n_it, pos,
                                     g_color.contiguous(), ray_grads=want_rays)
        return (g["centers"], g["radii"], g["albedo"], g["fuzz"], g["ior"], None, g_o, g_d,
                None, None)


def make_tape_tracer(key: torch.Tensor, max_depth: int, pool: int = 16384,
                     intersect_fn=closest_hit, use_fused: bool = False,
                     budget: Optional[int] = None, refill_every: int = 1,
                     use_mega: bool = False, ray_grads: bool = True, mega_bwd: bool = False,
                     device=None):
    """The tracer of given rays (tapegrad.py:1273): tracer(scene, ray_o
    [R, 3], ray_d [R, 3], k=None) -> colors [R, 3], differentiable in
    scene.centers, radii, albedo, fuzz and ior and in ray_o and ray_d.  k
    is the call's key (default `key`, a core/prng.py key).

    use_mega=False: the host-loop recording forward (_forward_tape) over a
    pool of min(pool, R) lanes refilled every refill_every bounces, its
    bounce intersect_fn (the dense closest_hit, K11's closest_hit_pallas,
    or make_culled_intersect's K12/K13) with threefry draws keyed by (tape
    row, lane), or with use_fused the fused bounce K10 (seed randint(k) +
    row * 65537, draws keyed by ray); budget caps the tape rows (default
    tape_budget's worst case; a truncated run gives NaN colors).  The
    backward walks the tape in reverse (_backward_tape).  pool, budget and
    refill_every change which draws a ray gets, so the image, as in JAX.

    use_mega=True: the recording forward in ray mode (K6), ray i's bounce
    draws keyed (i, randint(k) + depth * 65537); the backward is the dense
    reverse walk K7 with mega_bwd=True, or with mega_bwd=False its plain
    tensor-code walk (JAX computes that one outside any kernel).  pool,
    budget, refill_every, intersect_fn and use_fused are not used there.

    ray_grads=False: the backward skips the primary-ray cotangents, and
    ray_o and ray_d get zero gradients (the scene-only shape).  Runs on
    the CUDA card unless device says otherwise; scene and rays are moved
    to that device (differentiable moves)."""
    if mega_bwd and not use_mega:
        raise ValueError("mega_bwd requires use_mega (the mega tape)")
    prng.check_key(key)
    dev = resolve_device(device)
    fwd = dict(max_depth=int(max_depth), pool=int(pool), intersect_fn=intersect_fn,
               use_fused=bool(use_fused), budget=budget, refill_every=int(refill_every))
    cfg = dict(fwd=fwd, ray_grads=bool(ray_grads))

    def tracer(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor,
               k: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ray_o.dim() != 2 or ray_o.shape[1] != 3 or ray_d.shape != ray_o.shape:
            raise ValueError(f"ray_o and ray_d must be [R, 3], got {tuple(ray_o.shape)} and "
                             f"{tuple(ray_d.shape)}")
        kk = key if k is None else prng.check_key(k)
        s = scene.to(dev)
        f32 = dict(device=dev, dtype=torch.float32)
        o, d = ray_o.to(**f32), ray_d.to(**f32)
        if use_mega:
            kw = dict(bounce_seed=prng.bounce_seed(kk), max_depth=int(max_depth))
            return _TapeRayTrace.apply(s.centers, s.radii, s.albedo, s.fuzz, s.ior, s.mat_type,
                                       o, d, bool(ray_grads), kw, bool(mega_bwd))
        return _TapeHostTrace.apply(s.centers, s.radii, s.albedo, s.fuzz, s.ior, s.mat_type,
                                    o, d, kk, cfg)

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
