"""Path-replay gradients: the port of distributed_raytracer_tpu/grad/pathgrad.py.

The recording forward traces the rays with draws keyed per (ray, bounce)
(fold_in(fold_in(key, ray), bounce), split into the unit-vector and the
uniform key, JAX's threefry bit for bit, core/prng.py) and records, per
(bounce, ray), the incoming origin, direction and attenuation, the
winner, the hit and active flags and the draws (`_Step`).  Three forwards
give that record:

  scan       every ray to max_depth, bounce by bounce (`_forward_scan`),
             the inert rows after every ray finished recorded at no cost;
  wavefront  a persistent pool of lanes refilled from the ray stream
             (`_forward_wavefront`): the same draws whatever lane or
             iteration a ray runs in, so the same colors and records as
             the scan bit for bit (given an intersect that computes each
             ray alone, as K11 and its plain version do);
  fused      one fused bounce of all rays per depth (`_forward_scan_fused`,
             K10, ops/kernels/bounce_kernel.py), seed randint(key) + depth
             * 65537 and the ray index keying its draws, which it emits so
             that the backward replays them.

The backward (`_backward_pool`) replays the recorded bounces in reverse
through a pool of lanes fed longest path first: each iteration pulls one
bounce per lane through the VJP of the local bounce (`_local_bounce`,
torch.autograd.grad) with the recorded draws, and sums the sphere
cotangents by index_add_ into n + 1 segments (misses to the dropped one).
`make_pathgrad_tracer` joins forward and backward in a
torch.autograd.Function; use_custom_vjp=False returns the recording
forward itself, which autograd differentiates (the oracle).  The loops
run on the host, one Python iteration per bounce or pool step, on the
CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core import rng as drng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops import materials
from distributed_raytracer_tpu_torch.ops.camera import Camera, generate_rays
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit
from distributed_raytracer_tpu_torch.ops.kernels.bounce_kernel import (
    fused_bounce,
    fused_scene_arrays,
)
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import winner_t
from distributed_raytracer_tpu_torch.ops.trace import sky_color

PRIMALS = ("scan", "wavefront", "fused")


class _Step(NamedTuple):
    """Per-(bounce, ray) forward record, [max_depth, R, ...]."""

    o: torch.Tensor       # incoming origin [.., 3]
    d: torch.Tensor       # incoming direction [.., 3]
    atten: torch.Tensor   # incoming attenuation [.., 3]
    idx: torch.Tensor     # int32 winning sphere (junk where not hit)
    hit: torch.Tensor     # bool
    active: torch.Tensor  # bool: the lane was alive entering this bounce
    ruv: torch.Tensor     # the unit-vector draw [.., 3]
    u: torch.Tensor       # the uniform draw (the dielectric's choice)


def _ray_keys(key: torch.Tensor, n: int, device) -> torch.Tensor:
    """fold_in(key, i) for i in 0..n-1, [n, 2]."""
    return prng.fold_in_keys(prng.keys_of(key, device), torch.arange(n, device=device))


def _draws(keys: torch.Tensor):
    """(unit vector [B, 3], uniform [B]) from per-lane keys [B, 2]: each
    key split in two, the first giving the unit vector, the second the
    uniform."""
    k = prng.split_keys(keys)
    return drng.unit_vector_keys(k[:, 0]), prng.uniform_keys(k[:, 1])


def _draws_at(key: torch.Tensor, ray_ids: torch.Tensor, bounce_ids: torch.Tensor):
    """The draws of (ray, bounce) pairs: fold_in(fold_in(key, ray), bounce)."""
    keys = prng.fold_in_keys(prng.keys_of(key, ray_ids.device), ray_ids)
    return _draws(prng.fold_in_keys(keys, bounce_ids))


def _local_bounce(o, d, atten, color, params, ruv, u, hit, active):
    """One bounce from the gathered winner parameters and explicit draws,
    differentiable by autograd; returns (o, d, atten, color, keep)."""
    t = winner_t(o, d, params["centers"], params["radii"])
    t_safe = torch.where(hit, t, 1.0)
    sc = materials.scatter_gathered(None, o, d, t_safe, params, draws=(ruv, u))
    finish_miss = active & ~hit
    keep = active & hit & sc.scattered
    color2 = torch.where(finish_miss[:, None], atten * sky_color(d), color)
    k = keep[:, None]
    o2 = torch.where(k, sc.origin, o)
    d2 = torch.where(k, sc.direction, d)
    atten2 = torch.where(k, atten * sc.attenuation, atten)
    return o2, d2, atten2, color2, keep


def _gather_params(scene: Scene, idx, hit) -> dict:
    """The winners' parameters, radius and ior made safe (1) where the
    lane missed (its results are masked out)."""
    p = materials.gather_hit_params(scene, idx)
    p["radii"] = torch.where(hit, p["radii"], 1.0)
    p["ior"] = torch.where(hit, p["ior"], 1.0)
    return p


def local_vjp(o, d, atten, color, params, ruv, u, hit, active, cots):
    """The VJP of the local bounce's (o, d, atten, color) at one row of
    lanes: cots are their cotangents; returns the cotangents of (o, d,
    atten, color, centers, radii, albedo, fuzz, ior), zeros where an input
    does not reach the outputs."""
    names = ("centers", "radii", "albedo", "fuzz", "ior")
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in
              (o, d, atten, color, *(params[k] for k in names))]
        p = dict(params, **dict(zip(names, xs[4:])))
        outs = _local_bounce(*xs[:4], p, ruv, u, hit, active)[:4]
        return torch.autograd.grad(outs, xs, cots, allow_unused=True, materialize_grads=True)


def _stack_steps(recs) -> _Step:
    return _Step(*(torch.stack([x.detach() for x in field]) for field in zip(*recs)))


def _forward_scan(scene: Scene, ray_o, ray_d, key, max_depth: int, intersect_fn):
    """Every ray max_depth bounces, draws per (ray, bounce); returns
    (colors [R, 3], _Step).  Differentiable by autograd (the oracle)."""
    r, dev, ft = ray_o.shape[0], ray_o.device, ray_o.dtype
    keys_r = _ray_keys(key, r, dev)
    o, d = ray_o, ray_d
    atten = torch.ones(r, 3, dtype=ft, device=dev)
    color = torch.zeros(r, 3, dtype=ft, device=dev)
    active = torch.ones(r, dtype=torch.bool, device=dev)
    recs = []
    for i in range(max_depth):
        if not bool(active.any()):
            # every ray finished: the rest are inert rows, as JAX's lax.cond records them
            z = torch.zeros(r, dtype=ft, device=dev)
            recs.append(_Step(o, d, atten, torch.zeros(r, dtype=torch.int32, device=dev),
                              torch.zeros(r, dtype=torch.bool, device=dev), active,
                              torch.zeros(r, 3, dtype=ft, device=dev), z))
            continue
        res = intersect_fn(o, d, scene)
        params = _gather_params(scene, res.idx, res.hit)
        ruv, u = _draws(prng.fold_in_keys(keys_r, i))
        ruv, u = ruv.to(ft), u.to(ft)
        recs.append(_Step(o, d, atten, res.idx, res.hit, active, ruv, u))
        o, d, atten, color, active = _local_bounce(o, d, atten, color, params, ruv, u,
                                                   res.hit, active)
    return color, _stack_steps(recs)


def _forward_wavefront(scene: Scene, ray_o, ray_d, key, max_depth: int, pool: int,
                       intersect_fn):
    """The same record as _forward_scan from a persistent pool of
    min(pool, R) lanes refilled by cumsum rank; the draws of (ray, bounce)
    do not depend on the lane, so colors and records equal the scan's."""
    r, dev, ft = ray_o.shape[0], ray_o.device, ray_o.dtype
    b = min(pool, r)
    rows = max_depth * r + 1  # row max_depth * r: dropped
    st = _Step(o=torch.zeros(rows, 3, dtype=ft, device=dev),
               d=torch.zeros(rows, 3, dtype=ft, device=dev),
               atten=torch.zeros(rows, 3, dtype=ft, device=dev),
               idx=torch.zeros(rows, dtype=torch.int32, device=dev),
               hit=torch.zeros(rows, dtype=torch.bool, device=dev),
               active=torch.zeros(rows, dtype=torch.bool, device=dev),
               ruv=torch.zeros(rows, 3, dtype=ft, device=dev),
               u=torch.zeros(rows, dtype=ft, device=dev))
    o = torch.zeros(b, 3, dtype=ft, device=dev)
    d = torch.zeros(b, 3, dtype=ft, device=dev)
    atten = torch.ones(b, 3, dtype=ft, device=dev)
    lane_ray = torch.zeros(b, dtype=torch.int64, device=dev)
    lane_depth = torch.zeros(b, dtype=torch.int64, device=dev)
    live = torch.zeros(b, dtype=torch.bool, device=dev)
    color_out = torch.zeros(r + 1, 3, dtype=ft, device=dev)  # row r: dropped
    zero_c = torch.zeros(b, 3, dtype=ft, device=dev)
    emitted, any_live = 0, False
    while emitted < r or any_live:
        free = ~live
        rank = torch.cumsum(free, 0) - 1
        take = free & (rank < r - emitted)
        nr = torch.clamp(emitted + torch.where(take, rank, 0), 0, r - 1)
        tk = take[:, None]
        o = torch.where(tk, ray_o[nr], o)
        d = torch.where(tk, ray_d[nr], d)
        atten = torch.where(tk, 1.0, atten)
        lane_ray = torch.where(take, nr, lane_ray)
        lane_depth = torch.where(take, 0, lane_depth)
        live = live | take
        emitted += min(int(free.sum()), r - emitted)

        res = intersect_fn(o, d, scene)
        hit = res.hit & live
        params = _gather_params(scene, res.idx, hit)
        ruv, u = _draws_at(key, lane_ray, lane_depth)
        ruv, u = ruv.to(ft), u.to(ft)
        slot = torch.where(live, lane_depth * r + lane_ray, rows - 1)
        for dst, v in zip(st, (o, d, atten, res.idx, hit, live, ruv, u)):
            dst[slot] = v
        o, d, atten, color2, keep = _local_bounce(o, d, atten, zero_c, params, ruv, u, hit,
                                                  live)
        lane_depth = lane_depth + live.to(torch.int64)
        finished = live & ~keep
        color_out[torch.where(finished, lane_ray, r)] = color2
        live = keep & (lane_depth < max_depth)
        any_live = bool(live.any())
    steps = _Step(*(x[:rows - 1].reshape((max_depth, r) + x.shape[1:]) for x in st))
    return color_out[:r], steps


def _forward_scan_fused(scene: Scene, ray_o, ray_d, key, max_depth: int):
    """The recording forward on the fused bounce (K10 on CUDA tensors):
    one launch per depth over all R rays, seed randint(key) + depth * 65537,
    ray i's draws keyed by i; the kernel emits the draws it used."""
    r, dev = ray_o.shape[0], ray_o.device
    seed = prng.bounce_seed(key)
    arrays = fused_scene_arrays(scene)
    ray_id = torch.arange(r, dtype=torch.int32, device=dev)
    o, d = ray_o.contiguous(), ray_d.contiguous()
    atten = torch.ones(r, 3, dtype=torch.float32, device=dev)
    color = torch.zeros(r, 3, dtype=torch.float32, device=dev)
    active = torch.ones(r, dtype=torch.bool, device=dev)
    recs = []
    for i in range(max_depth):
        res = fused_bounce(o, d, active, ray_id, arrays, seed + i * 65537)
        recs.append(_Step(o, d, atten, res.idx, res.hit & active, active, res.ruv, res.u))
        fin = (res.finished == 1) & active
        color = torch.where(fin[:, None], atten * res.color, color)
        o, d, atten, active = res.new_o, res.new_d, atten * res.atten, active & ~fin
    return color, _stack_steps(recs)


def _backward_pool(scene: Scene, steps: _Step, g_color, max_depth: int, pool_divisor: int):
    """The reverse replay: a pool of max(128, R // pool_divisor) lanes
    walks each ray's recorded bounces from its last to its first, fed by a
    longest-path-first queue (a stable sort, as jnp.argsort is); a lane
    whose ray drained writes its primary-ray cotangents and takes the
    next ray.  Returns (d_scene dict of the five fields, g_ray_o, g_ray_d)."""
    r, dev, ft = g_color.shape[0], g_color.device, g_color.dtype
    b = max(128, r // pool_divisor)
    n = scene.num_spheres
    path_len = steps.active.sum(0)  # [R] int64
    queue = torch.argsort(-path_len, stable=True)
    flat = lambda x: x.reshape((max_depth * r,) + x.shape[2:])  # noqa: E731
    st = _Step(*(flat(x) for x in steps))

    lane_ray = torch.zeros(b, dtype=torch.int64, device=dev)
    ptr = torch.full((b,), -1, dtype=torch.int64, device=dev)
    cot = [torch.zeros(b, 3, dtype=ft, device=dev) for _ in range(4)]  # o, d, atten, color
    g = dict(centers=torch.zeros(n + 1, 3, dtype=ft, device=dev),
             radii=torch.zeros(n + 1, dtype=ft, device=dev),
             albedo=torch.zeros(n + 1, 3, dtype=ft, device=dev),
             fuzz=torch.zeros(n + 1, dtype=ft, device=dev),
             ior=torch.zeros(n + 1, dtype=ft, device=dev))
    g_ray = [torch.zeros(r + 1, 3, dtype=ft, device=dev) for _ in range(2)]  # row r: dropped
    zero_c = torch.zeros(b, 3, dtype=ft, device=dev)
    qpos, any_live = 0, False
    while qpos < r or any_live:
        free = ptr < 0
        rank = torch.cumsum(free, 0) - 1
        take = free & (rank < r - qpos)
        new_ray = queue[torch.clamp(qpos + torch.where(take, rank, 0), 0, r - 1)]
        lane_ray = torch.where(take, new_ray, lane_ray)
        ptr = torch.where(take, path_len[new_ray] - 1, ptr)
        tk = take[:, None]
        cot = [torch.where(tk, 0.0, c) for c in cot[:3]] + [
            torch.where(tk, g_color[new_ray], cot[3])]
        qpos += min(int(free.sum()), r - qpos)

        live = ptr >= 0
        fi = torch.clamp(ptr, 0, max_depth - 1) * r + lane_ray
        idx_i = st.idx[fi]
        hit_i = st.hit[fi] & live
        act_i = st.active[fi] & live
        params = _gather_params(scene, idx_i, hit_i)
        grads = local_vjp(st.o[fi], st.d[fi], st.atten[fi], zero_c, params, st.ruv[fi],
                          st.u[fi], hit_i, act_i, cot)
        lv = live[:, None]
        d_o, d_d, d_at, d_c = (torch.where(lv, x, 0.0) for x in grads[:4])
        seg = torch.where(hit_i, idx_i.to(torch.int64), n)
        for k, x in zip(("centers", "radii", "albedo", "fuzz", "ior"), grads[4:]):
            g[k].index_add_(0, seg, torch.where(lv if x.dim() == 2 else live, x, 0.0))
        ptr = torch.where(live, ptr - 1, ptr)
        # each ray drains once, so the written rows are unique (row r: dropped)
        slot = torch.where(live & (ptr < 0), lane_ray, r)
        g_ray[0][slot] = d_o
        g_ray[1][slot] = d_d
        cot = [d_o, d_d, d_at, d_c]
        any_live = bool((ptr >= 0).any())
    return {k: v[:n] for k, v in g.items()}, g_ray[0][:r], g_ray[1][:r]


class _PathTrace(torch.autograd.Function):
    """colors = trace(centers, radii, albedo, fuzz, ior, ray_o, ray_d);
    the backward is the path replay."""

    @staticmethod
    def forward(ctx, centers, radii, albedo, fuzz, ior, mat_type, ray_o, ray_d, k, cfg):
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        primal, depth = cfg["primal"], cfg["max_depth"]
        if primal == "fused":
            color, steps = _forward_scan_fused(scene, ray_o, ray_d, k, depth)
        elif primal == "wavefront":
            color, steps = _forward_wavefront(scene, ray_o, ray_d, k, depth,
                                              cfg["primal_pool"], cfg["intersect_fn"])
        else:
            color, steps = _forward_scan(scene, ray_o, ray_d, k, depth, cfg["intersect_fn"])
        ctx.save_for_backward(centers, radii, albedo, fuzz, ior, mat_type, *steps)
        ctx.cfg = cfg
        return color

    @staticmethod
    def backward(ctx, g_color):
        cfg = ctx.cfg
        centers, radii, albedo, fuzz, ior, mat_type, *steps = ctx.saved_tensors
        scene = Scene(centers=centers, radii=radii, albedo=albedo, mat_type=mat_type,
                      fuzz=fuzz, ior=ior)
        g, g_o, g_d = _backward_pool(scene, _Step(*steps), g_color.contiguous(),
                                     cfg["max_depth"], cfg["pool_divisor"])
        return (g["centers"], g["radii"], g["albedo"], g["fuzz"], g["ior"], None, g_o, g_d,
                None, None)


def make_pathgrad_tracer(key: torch.Tensor, max_depth: int, pool_divisor: int = 4,
                         intersect_fn=closest_hit, use_custom_vjp: bool = True,
                         primal: str = "scan", primal_pool: int = 65536, device=None):
    """tracer(scene, ray_o [R, 3], ray_d [R, 3], k=None) -> colors [R, 3]
    with the path-replay backward (pathgrad.py:311), differentiable in
    scene.centers, radii, albedo, fuzz and ior and in the rays.  k is the
    call's key (default `key`, a core/prng.py key).

    primal: "scan", "wavefront" (primal_pool lanes; colors equal the
    scan's bit for bit) or "fused" (K10; intersect_fn unused).
    use_custom_vjp=False returns the scan forward itself, differentiated
    by autograd (the oracle).  Runs on the CUDA card unless device says
    otherwise; scene and rays are moved there (differentiable moves)."""
    if primal not in PRIMALS:
        raise ValueError(f"unknown primal {primal!r}")
    prng.check_key(key)
    dev = resolve_device(device)
    cfg = dict(max_depth=int(max_depth), pool_divisor=int(pool_divisor),
               intersect_fn=intersect_fn, primal=primal, primal_pool=int(primal_pool))

    def tracer(scene: Scene, ray_o: torch.Tensor, ray_d: torch.Tensor,
               k: Optional[torch.Tensor] = None) -> torch.Tensor:
        kk = key if k is None else prng.check_key(k)
        s = scene.to(dev)
        o, d = ray_o.to(dev), ray_d.to(dev)
        if not use_custom_vjp:
            return _forward_scan(s, o, d, kk, cfg["max_depth"], intersect_fn)[0]
        return _PathTrace.apply(s.centers, s.radii, s.albedo, s.fuzz, s.ior, s.mat_type, o, d,
                                kk, cfg)

    return tracer


def make_image_grad_fn(camera: Camera, max_depth: Optional[int] = None,
                       pool_divisor: int = 8, intersect_fn=closest_hit, seed: int = 0,
                       device=None):
    """grad_fn(scene, target [H*W, 3], sample_indices) -> (loss, dict of
    the five fields' gradients) with the path-replay tracer
    (pathgrad.py:508): sample s draws its camera rays from split(fold_in(
    PRNGKey(seed), s))[0] and traces them with [1]; the loss is the mean
    squared error of the mean image over the samples against target.
    Runs on the CUDA card unless device says otherwise."""
    dev = resolve_device(device)
    depth = camera.max_depth if max_depth is None else int(max_depth)
    root = prng.PRNGKey(seed)
    cam = camera.to(dev)
    w, n_pix = camera.image_width, camera.num_pixels
    ids = torch.arange(n_pix, device=dev)
    tracer = make_pathgrad_tracer(root, depth, pool_divisor=pool_divisor,
                                  intersect_fn=intersect_fn, device=dev)

    def grad_fn(scene: Scene, target, sample_indices):
        params = {k: v.detach().to(dev).requires_grad_() for k, v in scene.diff_params().items()}
        s2 = scene.to(dev).with_diff_params(params)
        tgt = torch.as_tensor(target, dtype=torch.float32).to(dev).reshape(n_pix, 3)
        samples = [int(x) for x in sample_indices]
        acc = torch.zeros(n_pix, 3, dtype=torch.float32, device=dev)
        for si in samples:
            k_cam, k_trace = prng.split(prng.fold_in(root, si))
            o, d = generate_rays(cam, ids % w, ids // w, key=k_cam)
            acc = acc + tracer(s2, o, d, k_trace)
        loss = torch.mean((acc / len(samples) - tgt) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    return grad_fn
