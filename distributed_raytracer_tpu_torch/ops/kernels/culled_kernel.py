"""Host-side scene prep for the chunk walk: spheres reordered into
spatially tight chunks, each with a bounding sphere.

Port of the host half of the JAX package's ops/pallas/culled_kernel.py
(`CulledScene`, `build_culled_scene`).  Spheres of radius >= big_threshold
(the ground sphere) go into leading chunks whose bound is infinite, so
every walk sweeps them; the rest are Morton-ordered by the native cluster
builder (distributed_raytracer_tpu_torch/native.py) and padded with -1
slots to a multiple of the chunk.  The walk (K9) and the culled fused
bounce (K14) read a CulledScene through their packs
(mega_walk_kernel.py::build_walk_pack, culled_bounce_kernel.py::
build_culled_pack).

The block-culled closest hit of that file (K12 `_culled_kernel`, mode
"grid"; K13 `_walk_kernel`, mode "walk") is `make_culled_intersect`: per
block of rays a front-to-back chunk visit plan (`block_visit_plan`, JAX's
_block_visit_plan in tensor code), then on CUDA tensors the hand-written
csrc/culled_intersect.cu (one body, two instantiations), on CPU tensors
`culled_closest_hit_plain`.  Its gradient is K11's winner-only backward
(intersect_kernel.py).  visit_sorted_bounds, the TPU's visit-ordered
bound tiles, has no counterpart: a ray reads bounds[order[b, p]].

Both culled kernels of the port (K12/K13 here, K14 in
culled_bounce_kernel.py) walk a ray's chunks with a group of lanes
(csrc/trace.cuh group_walk), and both dense ones (K11 in
intersect_kernel.py, K10 in bounce_kernel.py) sweep the scene with a
group of lanes (group_sweep).  `group_walk_plain` and `group_sweep_plain`
are plain models of those schedules for the tests, which hold them to the
sweep of one thread per ray; nothing on the card path calls them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch import native
from distributed_raytracer_tpu_torch.core.vecmath import BIG, T_MIN
from distributed_raytracer_tpu_torch.models.scene import ABSORB, Scene
from distributed_raytracer_tpu_torch.ops.intersect import HitResult
from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce import sweep_t
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import (
    WinnerOnlyHit,
    check_rays,
    sphere_pack,
)
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import _PLAIN_ELEMS

LANE = 128
DEFAULT_BR = 512  # rays per plan block (culled_kernel.py:46)
# the counters of a culled launch, in the order of its `stats` tensor
CULLED_STATS = ("rays", "bound_tests", "admitted", "tests", "near")
# group_walk_plain's counts: CULLED_STATS' walk counters, the slot-test
# lanes the groups issue (G x the rounds of each admitted chunk), and the
# prefilter's candidates that the exact recheck rejected
GROUP_COUNTS = ("bound_tests", "admitted", "tests", "near", "issued", "rechecked_out")
GROUP = 8  # bound rows are padded to whole groups of this many (the TPU's flag tests)


class CulledScene(NamedTuple):
    """A Scene reordered for the chunk walk, and its chunk bounds."""

    scene: Scene            # chunk-ordered, padded to n_chunks * chunk (CPU tensors)
    bounds_c: np.ndarray    # [n_chunks, 3] f32 bound centers
    bounds_r2: np.ndarray   # [n_chunks] f32 bound radius^2 (inf: always swept)
    chunk: int              # spheres per chunk
    order: np.ndarray       # [n_chunks * chunk] int64 original index per slot, -1 padding


def build_culled_scene(scene: Scene, chunk: int = LANE,
                       big_threshold: float = 50.0) -> CulledScene:
    """Reorder a scene into walk chunks (culled_kernel.py:61-134): the big
    spheres first, in always-swept chunks, then the rest in Morton order;
    spheres of radius <= 0 are left out."""
    centers = scene.centers.detach().cpu().numpy().astype(np.float32)
    radii = scene.radii.detach().cpu().numpy().astype(np.float32)
    real = radii > 0
    big = real & (radii >= big_threshold)
    small_idx = np.where(real & ~big)[0]
    if len(small_idx):
        order_local, bounds = native.build_clusters(centers[small_idx], radii[small_idx], chunk)
        small_sorted = small_idx[order_local]
    else:
        small_sorted = small_idx
        bounds = np.zeros((0, 4), np.float32)

    big_idx = np.where(big)[0]
    n_big = -(-len(big_idx) // chunk)
    n_small = -(-len(small_sorted) // chunk)
    n_chunks = max(n_big + n_small, 1)

    def pad_ids(ids, n_chunks_for):
        return np.concatenate([ids, np.full(n_chunks_for * chunk - len(ids), -1, np.int64)])

    order = np.concatenate([pad_ids(big_idx, n_big),
                            pad_ids(small_sorted, max(n_small, 1 - n_big))])
    valid = torch.from_numpy(order >= 0)
    src = torch.from_numpy(np.clip(order, 0, len(radii) - 1))

    def take(x, fill):
        v = valid.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(v, x.detach().cpu()[src], torch.full_like(x.detach().cpu()[src], fill))

    reordered = Scene(centers=take(scene.centers, 0.0), radii=take(scene.radii, 0.0),
                      albedo=take(scene.albedo, 0.0), mat_type=take(scene.mat_type, ABSORB),
                      fuzz=take(scene.fuzz, 0.0), ior=take(scene.ior, 1.0))
    bc = np.zeros((n_chunks, 3), np.float32)
    br2 = np.full((n_chunks,), np.float32(np.inf))
    for c in range(min(n_small, len(bounds))):
        bc[n_big + c] = bounds[c, :3]
        br2[n_big + c] = bounds[c, 3] ** 2
    return CulledScene(scene=reordered, bounds_c=bc, bounds_r2=br2, chunk=chunk, order=order)


def inflate_r2(bounds_r2: torch.Tensor) -> torch.Tensor:
    """The plan's reach-test bound radius^2: r2 (1 + 1e-4) + 1e-5 where
    finite, so float32 rounding can only err toward visiting a chunk."""
    return torch.where(torch.isfinite(bounds_r2), bounds_r2 * (1.0 + 1e-4) + 1e-5, bounds_r2)


def plan_blocks(r: int, block_rays: int = DEFAULT_BR) -> Tuple[int, int]:
    """(rays per block br, n_blocks) of a plan over r rays (_culled_fwd)."""
    br = min(block_rays, max(LANE, -(-r // LANE) * LANE))
    return br, -(-r // br)


def block_visit_plan(ray_o: torch.Tensor, ray_d: torch.Tensor, bounds_c: torch.Tensor,
                     bounds_r2: torch.Tensor, n_blocks: int, br: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per ray block (br rays, the last padded with zero rays) the chunk
    visit order [n_blocks, C] int32 and the reachable count [n_blocks]
    int32 (culled_kernel.py:215): chunks sorted by the distance along the
    block's mean ray to their bound centers, the always-swept ones first,
    those no ray of the block can reach (the inflated bound, exact per
    ray) last and not counted.  The sort is stable, as jnp.argsort is, so
    ties keep JAX's order."""
    r = ray_o.shape[0]
    pad = n_blocks * br - r
    ob = torch.nn.functional.pad(ray_o, (0, 0, 0, pad)).reshape(n_blocks, br, 3)
    db = torch.nn.functional.pad(ray_d, (0, 0, 0, pad)).reshape(n_blocks, br, 3)
    o_mean = ob.mean(dim=1)
    d_mean = db.mean(dim=1)
    d_mean = d_mean / (torch.linalg.norm(d_mean, dim=-1, keepdim=True) + 1e-12)
    rel = bounds_c[None, :, :] - o_mean[:, None, :]
    dist = torch.clamp_min(torch.einsum("bcx,bx->bc", rel, d_mean), 0.0)

    r2_pad = inflate_r2(bounds_r2)
    a = (db * db).sum(-1)
    db_bc = torch.einsum("brx,cx->brc", db, bounds_c)
    ob_bc = torch.einsum("brx,cx->brc", ob, bounds_c)
    hb = db_bc - (db * ob).sum(-1)[..., None]
    cb = ((bounds_c * bounds_c).sum(-1)[None, None] - 2.0 * ob_bc
          + (ob * ob).sum(-1)[..., None] - r2_pad[None, None])
    disc = hb * hb - a[..., None] * cb
    ok = disc >= 0.0
    far = hb + torch.sqrt(torch.where(ok, disc, 0.0))  # = farb * a
    reach = (ok & (far > T_MIN * a[..., None]) & (a[..., None] > 0.0)).any(dim=1)
    always = ~torch.isfinite(bounds_r2)[None, :]
    reach = reach | always
    key = torch.where(always, -1.0, torch.where(reach, dist, torch.inf))
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    return order.contiguous(), reach.sum(dim=1).to(torch.int32)


def culled_closest_hit_plain(ray_o: torch.Tensor, ray_d: torch.Tensor, sph: torch.Tensor,
                             order: torch.Tensor, chunk: int, br: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [R], idx [R] int32) with no culling: each ray's per-chunk minimum
    and first argmin over the packed slots sph [n_chunks * chunk, 4],
    reduced over its block's visit order (order [n_blocks, n_chunks]) with
    a strict <, which keeps the first position of the least t; a miss
    gives (BIG, 0).  Both kernel modes compute this function."""
    n_chunks = order.shape[1]
    cols = sph.t()
    step = max(1, _PLAIN_ELEMS // sph.shape[0])
    ts, idxs = [], []
    for i in range(0, ray_o.shape[0], step):
        ox, oy, oz = ray_o[i:i + step].unbind(-1)
        dx, dy, dz = ray_d[i:i + step].unbind(-1)
        a = dx * dx + dy * dy + dz * dz
        t, _ = sweep_t(ox, oy, oz, dx, dy, dz, a, 1.0 / a, cols)
        tc, ic = torch.min(t.view(-1, n_chunks, chunk), dim=2)  # per chunk, first argmin
        ic = ic + torch.arange(n_chunks, device=ic.device) * chunk
        plan = order.long()[torch.arange(i, i + t.shape[0], device=order.device) // br]
        tv, pos = torch.min(tc.gather(1, plan), dim=1)  # the first position of the least t
        iv = ic.gather(1, plan).gather(1, pos[:, None])[:, 0]
        ts.append(tv)
        idxs.append(torch.where(tv < BIG, iv, 0).to(torch.int32))
    return torch.cat(ts), torch.cat(idxs)


def chunk_admits_plain(bounds, ox, oy, oz, dx, dy, dz, a, inv_a, best):
    """[R, C] bool: the walk's chunk test (csrc/trace.cuh chunk_admits) of
    rays [R] against bounds [C, 4] (the same chunks for every ray) or
    [R, C, 4] (each ray's own), with best [R, C] each ray's best t before
    the chunk."""
    bx, by, bz, br2 = (bounds[..., k] for k in range(4))
    obx = bx - ox[:, None]
    oby = by - oy[:, None]
    obz = bz - oz[:, None]
    hb = dx[:, None] * obx + dy[:, None] * oby + dz[:, None] * obz
    cb = obx * obx + oby * oby + obz * obz - br2
    discb = hb * hb - a[:, None] * cb
    ok = discb >= 0.0
    sq = torch.sqrt(torch.where(ok, discb, 0.0))
    inv = inv_a[:, None]
    nearb = (hb - sq) * inv
    farb = (hb + sq) * inv
    admit = ok & (farb > T_MIN) & (nearb < best)
    return torch.where(torch.isinf(br2), br2 > 0.0, admit)


def group_walk_plain(ray_o, ray_d, sph, bounds, plan, n_pos, lens, chunk: int, group: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """A plain model of the group walk's schedule (csrc/trace.cuh
    group_walk), `group` lanes per ray: rays [R, 3]; slots sph [n_slots, 4]
    (cx, cy, cz, r2), chunk c's at c * chunk; bounds [>= C, 4]; plan
    [R, P] the chunk at each position of a ray's walk and n_pos [R] the
    positions it walks; lens [C] the slots each chunk sweeps.

    Per window of `group` positions the prefilter tests each against the
    ray's best t at the window's start; the candidates are taken in
    ascending position and, once best has fallen, tested again against the
    current best; an admitted chunk's slots are dealt to the lanes (lane q:
    slots q, q + group, ...), each lane keeps its first least t, and the
    group's least t, then least slot at that t, merges into best with a
    strict <.  Returns (t [R], idx [R] int32, counts by GROUP_COUNTS); t
    and idx are the walk's of one thread per ray, bit for bit, and so are
    the counts it also gives (group = 1 is that walk)."""
    r = ray_o.shape[0]
    ox, oy, oz = ray_o.unbind(-1)
    dx, dy, dz = ray_d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    t_all, ok_all = sweep_t(ox, oy, oz, dx, dy, dz, a, inv_a, sph.t())  # each slot's test
    plan, lens = plan.long(), lens.long()
    slot = torch.arange(chunk, device=ray_o.device)
    rounds = -(-chunk // group)
    pad = rounds * group - chunk
    best = torch.full((r,), BIG, dtype=ray_o.dtype, device=ray_o.device)
    bi = torch.zeros(r, dtype=torch.int64, device=ray_o.device)
    counts = dict.fromkeys(GROUP_COUNTS, 0)
    for p0 in range(0, plan.shape[1], group):
        c = plan[:, p0:p0 + group]
        live = torch.arange(p0, p0 + c.shape[1], device=c.device)[None, :] < n_pos[:, None]
        b = bounds[c]
        counts["bound_tests"] += int((live & torch.isfinite(b[..., 3])).sum())
        cand = live & chunk_admits_plain(b, ox, oy, oz, dx, dy, dz, a, inv_a, best[:, None])
        stale = best
        for k in range(c.shape[1]):
            ck = c[:, k]
            recheck = cand[:, k] & (best < stale)
            exact = chunk_admits_plain(bounds[ck][:, None], ox, oy, oz, dx, dy, dz, a, inv_a,
                                       best[:, None])[:, 0]
            adm = cand[:, k] & (~recheck | exact)
            counts["rechecked_out"] += int((recheck & ~exact).sum())
            ln = lens[ck]
            j = ck[:, None] * chunk + slot
            swept = slot[None, :] < ln[:, None]
            tj = torch.where(swept, t_all.gather(1, j), BIG)
            lane_t = torch.nn.functional.pad(tj, (0, pad), value=BIG).view(r, rounds, group)
            lane_j = torch.nn.functional.pad(j, (0, pad)).view(r, rounds, group)
            lt, at = torch.min(lane_t, dim=1)  # each lane's first least t
            lj = lane_j.gather(1, at[:, None])[:, 0]
            tmin = lt.min(dim=1).values
            jmin = torch.where(lt == tmin[:, None], lj, torch.iinfo(torch.int64).max).amin(1)
            win = adm & (tmin < best)
            best = torch.where(win, tmin, best)
            bi = torch.where(win, jmin, bi)
            counts["admitted"] += int(adm.sum())
            counts["tests"] += int(ln[adm].sum())
            counts["near"] += int((ok_all.gather(1, j) & swept)[adm].sum())
            counts["issued"] += int((group * -(-ln // group))[adm].sum())
    return best, bi.to(torch.int32), counts


def group_sweep_plain(ray_o, ray_d, sph, group: int) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """A plain model of the dense group sweep (csrc/trace.cuh group_sweep,
    K10 and K11), `group` lanes per ray over the spheres sph [n, 4]: the
    group walk's schedule (group_walk_plain) over one chunk of all n
    spheres with an infinite bound, which every ray sweeps.  Lane q tests
    spheres q, q + group, ...; each lane keeps its first least t and the
    group's least t, then least index at that t, wins.  Returns (t [R], idx
    [R] int32, counts by GROUP_COUNTS: n tests a ray, those with disc >= 0,
    group x ceil(n / group) slot-test lanes issued a ray)."""
    r, n = ray_o.shape[0], sph.shape[0]
    dev = ray_o.device
    bound = torch.tensor([[0.0, 0.0, 0.0, float("inf")]], dtype=sph.dtype, device=dev)
    plan = torch.zeros(r, 1, dtype=torch.int64, device=dev)  # every ray: chunk 0, once
    n_pos = torch.ones(r, dtype=torch.int64, device=dev)
    return group_walk_plain(ray_o, ray_d, sph, bound, plan, n_pos, torch.tensor([n], device=dev),
                            n, group)


def _lib():
    lib = _build.load("culled_intersect")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.culled_closest_hit_launch.argtypes = [p, p, i, p, p, p, p, i, i, i, i, p, p, p, p, p]
    lib.culled_closest_hit_launch.restype = i
    return lib


def group_shape() -> Tuple[int, int]:
    """(lanes per ray, threads per block) of the built K12/K13."""
    shape = (ctypes.c_int * 2)()
    _lib().culled_closest_hit_shape(shape)
    return shape[0], shape[1]


def check_counter(x: Optional[torch.Tensor], name: str, n: int, dev) -> None:
    """A counter tensor, when given, is an int64 tensor of at least n
    entries on dev."""
    if x is not None and (x.device != dev or x.dtype != torch.int64 or x.numel() < n):
        raise ValueError(f"{name} must be an int64 [{n}] tensor on the rays' device")


def _culled_launch(walk: bool, ray_o, ray_d, sph, bounds, order, n_visit, chunk: int, br: int,
                   stats: Optional[torch.Tensor], issued: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    r = check_rays(ray_o, ray_d, sph)
    n_blocks, n_chunks = order.shape
    dev = ray_o.device
    for name, x, dtype, shape in (("bounds", bounds, torch.float32, (n_chunks, 4)),
                                  ("order", order, torch.int32, (n_blocks, n_chunks)),
                                  ("n_visit", n_visit, torch.int32, (n_blocks,))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or \
                not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
                             f"the rays' device")
    if sph.shape[0] != n_chunks * chunk or n_blocks * br < r or br < 1:
        raise ValueError(f"bad culled operands: {sph.shape[0]} slots, {n_chunks} chunks of "
                         f"{chunk}, {n_blocks} blocks of {br} for {r} rays")
    check_counter(stats, "stats", len(CULLED_STATS), dev)
    check_counter(issued, "issued", 1, dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    err = _lib().culled_closest_hit_launch(
        ray_o.data_ptr(), ray_d.data_ptr(), r, sph.data_ptr(), bounds.data_ptr(),
        order.data_ptr(), n_visit.data_ptr(), n_chunks, chunk, br, int(walk), t.data_ptr(),
        idx.data_ptr(), None if stats is None else stats.data_ptr(),
        None if issued is None else issued.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "culled_closest_hit_launch")
    return t, idx


def culled_closest_hit_cuda(ray_o, ray_d, sph, bounds, order, n_visit, chunk: int, br: int, *,
                            stats: Optional[torch.Tensor] = None,
                            issued: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K12 (csrc/culled_intersect.cu, WALK = false: every position
    of the plan) on the current stream (no sync).  bounds [n_chunks, 4]
    (bx, by, bz, inflated r2), order and n_visit from block_visit_plan;
    stats, int64 [5], gains the launch's CULLED_STATS, and issued, int64
    [1], the slot-test lanes its groups issued."""
    out = _culled_launch(False, ray_o, ray_d, sph, bounds, order, n_visit, chunk, br, stats,
                         issued)
    culled_closest_hit_cuda.launches += 1
    return out


def culled_closest_hit_walk_cuda(ray_o, ray_d, sph, bounds, order, n_visit, chunk: int,
                                 br: int, *, stats: Optional[torch.Tensor] = None,
                                 issued: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K13 (csrc/culled_intersect.cu, WALK = true: the first
    n_visit[b] positions of the plan); culled_closest_hit_cuda's operands."""
    out = _culled_launch(True, ray_o, ray_d, sph, bounds, order, n_visit, chunk, br, stats,
                         issued)
    culled_closest_hit_walk_cuda.launches += 1
    return out


culled_closest_hit_cuda.launches = 0
culled_closest_hit_walk_cuda.launches = 0


def culled_bounds(culled: CulledScene, device) -> torch.Tensor:
    """[n_chunks, 4] f32 (bx, by, bz, inflated r2) on device: the bounds the
    kernels test each ray against."""
    bc = torch.from_numpy(culled.bounds_c).to(device)
    br2 = inflate_r2(torch.from_numpy(culled.bounds_r2).to(device))
    return torch.cat([bc, br2[:, None]], dim=1).contiguous()


def make_culled_intersect(culled: CulledScene, block_rays: int = DEFAULT_BR,
                          mode: str = "grid"):
    """intersect_fn for ops/trace.py: the closest hit through the block-
    culled sweep, K12 (mode="grid") or K13 (mode="walk") on CUDA tensors,
    their plain version on CPU tensors.  Trace culled.scene (the reordered
    scene) with it, so the material gathers see the same sphere order; the
    plan is computed from each call's rays.  Differentiable in the rays and
    the scene's centers and radii through K11's winner-only backward."""
    if mode not in ("grid", "walk"):
        raise ValueError(f"unknown mode {mode!r}")
    launch = culled_closest_hit_walk_cuda if mode == "walk" else culled_closest_hit_cuda
    per_device = {}

    def fwd(ray_o, ray_d, centers, radii):
        dev = ray_o.device
        if dev not in per_device:
            per_device[dev] = (torch.from_numpy(culled.bounds_c).to(dev),
                               torch.from_numpy(culled.bounds_r2).to(dev),
                               culled_bounds(culled, dev))
        bc, br2, bounds = per_device[dev]
        if ray_o.dtype != bc.dtype:  # a float64 run of the plain version
            bc, br2 = bc.to(ray_o.dtype), br2.to(ray_o.dtype)
        br, n_blocks = plan_blocks(ray_o.shape[0], block_rays)
        order, n_visit = block_visit_plan(ray_o, ray_d, bc, br2, n_blocks, br)
        sph = sphere_pack(centers, radii)
        if dev.type == "cpu":
            return culled_closest_hit_plain(ray_o, ray_d, sph, order, culled.chunk, br)
        return launch(ray_o.contiguous(), ray_d.contiguous(), sph, bounds, order, n_visit,
                      culled.chunk, br)

    def intersect(ray_o: torch.Tensor, ray_d: torch.Tensor, scene: Scene) -> HitResult:
        t, idx, hit = WinnerOnlyHit.apply(fwd, ray_o, ray_d, scene.centers, scene.radii)
        return HitResult(t=t, idx=idx, hit=hit)

    return intersect
