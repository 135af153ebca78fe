"""The walk engine: the render and the recording forward past 512 spheres.

Port of distributed_raytracer_tpu/ops/pallas/mega_walk_kernel.py.  The
scene is a walk pack: its spheres in chunks of `chunk` slots, Morton-
ordered (ops/kernels/culled_kernel.py), the chunks in visit order (the
always-swept big chunks first, then ascending distance of the chunk's
bound center from the camera), each chunk with a bounding sphere.  Per
bounce a ray sweeps only the chunks it can still hit closer than its best
t so far.  On a CUDA tensor `mega_walk_sample` and `mega_walk_forward_camera`
launch the hand-written kernel csrc/mega_walk.cu (render and record); on a
CPU tensor they run the plain versions: the dense plain trace of
ops/kernels/mega_render_kernel.py over the visit-ordered slots, with no
culling.  The walk merges chunks with a strict < in visit order, so its
winner is the dense argmin over those slots, ties included, and a cull
that is not conservative shows up as a difference.  The plain versions
also count what the walk runs (each chunk's bound test against the best t
of the chunks before it), so the kernel's counters can be held to them.

Draws are the dense engine's (rid, depth)-keyed hash, so at equal scene
content the walk's image equals `mega_render_colors`' bit for bit (exact
float ties between spheres in different chunks aside), and a tape's winner
index is the slot (`WalkPack.slot_to_orig` maps it back).

The scene columns are the port's f32 sweep columns and winner attributes
in slot order; the TPU's bf16 hi/mid/lo planes are its layout and are not
copied.  The TPU arguments pool, budget, block_rays, the clean flag and
its re-render, `mega_walk_supported` (a VMEM limit) and the tiled pixel
tables (`tile_pix_tables`; draws are keyed by global pixel, so tiling
cannot change an image) have no counterpart: every ray runs to its end.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.core.vecmath import BIG
from distributed_raytracer_tpu_torch.models.scene import ABSORB, Scene
from distributed_raytracer_tpu_torch.ops.camera import CAM_ROW, Camera, camera_scalar_row
from distributed_raytracer_tpu_torch.ops.kernels import _build
from distributed_raytracer_tpu_torch.ops.kernels.bounce import (
    A_ROWS,
    scene_sweep_arrays,
    sweep_t,
    winner_of,
)
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import (
    GROUP,
    CulledScene,
    build_culled_scene,
    chunk_admits_plain,
)
from distributed_raytracer_tpu_torch.ops.kernels.hash import wrap_i32
from distributed_raytracer_tpu_torch.ops.kernels.mega_kernel import (
    TAPE_COLS,
    mega_forward_camera_plain,
)
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import mega_render_plain

_MASK32 = 0xFFFFFFFF
# the walk's counters, in the order of every `stats` tensor: (ray, bounce)
# sweeps, chunks admitted, slot tests in them, those tests with disc >= 0
STATS = ("bounces", "admitted", "tests", "near")
# the kernel's warp counters, which depend on the schedule: the (warp,
# step) pairs that swept, and the slot-test rounds the warps issued
# (csrc/trace.cuh WalkChunks)
WARP_STATS = ("warp_steps", "warp_tests")


class WalkPack(NamedTuple):
    """The scene as the walk reads it, slots in visit order."""

    scene_pack: torch.Tensor  # [n_slots, 4] f32: cx, cy, cz, r2 (-1: never hits)
    attrs: torch.Tensor       # [11, n_slots] f32 winner attributes (bounce.py A_*, idx = slot)
    bounds: torch.Tensor      # [c_pad, 4] f32: bx, by, bz, r2 (inf: always swept; pad rows -1)
    chunk_len: torch.Tensor   # [n_chunks] int32: the leading slots of a chunk that hold a sphere
    chunk: int
    n_chunks: int
    slot_to_orig: np.ndarray  # [n_slots] int64 original sphere per slot, -1 padding

    @property
    def n_slots(self) -> int:
        return self.chunk * self.n_chunks

    def to(self, device) -> "WalkPack":
        return self._replace(**{k: getattr(self, k).to(device)
                                for k in ("scene_pack", "attrs", "bounds", "chunk_len")})


def chunk_lengths(slot_to_orig: np.ndarray, chunk: int) -> np.ndarray:
    """[n_chunks] int32: each chunk's slots up to its last sphere (the
    builder puts padding slots last)."""
    valid = np.asarray(slot_to_orig).reshape(-1, chunk) >= 0
    last = chunk - np.argmax(valid[:, ::-1], axis=1)
    return np.where(valid.any(axis=1), last, 0).astype(np.int32)


def walk_pack_arrays_from_scene(scene: Scene, slot_to_orig, chunk: int):
    """(scene_pack [n_slots, 4], attrs [11, n_slots], slot-ordered Scene)
    for a fixed slot -> original permutation (mega_walk_kernel.py:147-195),
    by torch gathers, differentiable in the scene's tensors.  Padding slots
    (-1) get r = 0 (r2 = -1), mat = ABSORB, ior = 1.  The bounds are not
    rebuilt: they belong to the scene the permutation was built for."""
    dev = scene.centers.device
    sto = torch.as_tensor(slot_to_orig, dtype=torch.int64, device=dev)
    if sto.shape[0] % chunk:
        raise ValueError(f"{sto.shape[0]} slots are not whole chunks of {chunk}")
    v = sto >= 0
    src = sto.clamp(0, scene.num_spheres - 1)
    v3 = v[:, None]
    rs = Scene(centers=torch.where(v3, scene.centers[src], 0.0),
               radii=torch.where(v, scene.radii[src], 0.0),
               albedo=torch.where(v3, scene.albedo[src], 0.0),
               mat_type=torch.where(v, scene.mat_type[src], ABSORB).to(torch.int32),
               fuzz=torch.where(v, scene.fuzz[src], 0.0),
               ior=torch.where(v, scene.ior[src], 1.0))
    cols, attrs = scene_sweep_arrays(rs)
    return cols.t().contiguous(), attrs, rs


def build_walk_pack(culled: CulledScene, cam_center) -> WalkPack:
    """The visit-ordered pack of a CulledScene (mega_walk_kernel.py:
    111-144): chunks with an infinite bound first, then ascending distance
    of the bound center from cam_center."""
    bc, br2 = culled.bounds_c, culled.bounds_r2
    cam = np.asarray(cam_center, np.float64).reshape(3)
    dist = np.linalg.norm(bc.astype(np.float64) - cam, axis=-1)
    dist = np.where(np.isinf(br2), -1.0, dist)  # big chunks lead
    return pack_in_order(culled, np.argsort(dist, kind="stable").astype(np.int64))


def pack_in_order(culled: CulledScene, order: np.ndarray) -> WalkPack:
    """The pack of a CulledScene with its chunks in the given visit order
    ([n_chunks] chunk ids); bound rows padded to whole GROUPs plus one with
    r2 = -1."""
    bc, br2, chunk = culled.bounds_c, culled.bounds_r2, culled.chunk
    n_chunks = br2.shape[0]
    c_pad = (-(-n_chunks // GROUP) + 1) * GROUP
    bounds = np.zeros((c_pad, 4), np.float32)
    bounds[:n_chunks, 0:3] = bc[order]
    bounds[:n_chunks, 3] = br2[order]
    bounds[n_chunks:, 3] = -1.0
    slots = (order[:, None] * chunk + np.arange(chunk)).reshape(-1)
    scene_pack, attrs, _ = walk_pack_arrays_from_scene(culled.scene, slots, chunk)
    sto = culled.order.reshape(n_chunks, chunk)[order].reshape(-1)
    return WalkPack(scene_pack=scene_pack, attrs=attrs, bounds=torch.from_numpy(bounds),
                    chunk_len=torch.from_numpy(chunk_lengths(sto, chunk)), chunk=chunk,
                    n_chunks=n_chunks, slot_to_orig=sto)


def walk_pack_for(scene: Scene, camera: Camera, chunk: int = 256) -> WalkPack:
    """Host-side scene prep (mega_walk_kernel.py:900): Morton chunks and
    the camera's visit order.  A CPU pack; `WalkPack.to` moves it."""
    culled = build_culled_scene(scene.to("cpu"), chunk=chunk)
    return build_walk_pack(culled, camera.center.detach().cpu().numpy())


def walk_sweep(cols, attrs, bounds, n_chunks: int, tally: torch.Tensor):
    """trace_plain's sweep for the walk: the dense sweep over the slots,
    and into tally [3] the chunks the walk admits, their live slot tests
    and those with disc >= 0."""
    n = cols.shape[1]
    chunk = n // n_chunks
    b = bounds[:n_chunks]
    live = cols[3] >= 0.0
    live_per_chunk = live.view(n_chunks, chunk).sum(1)

    def sweep(ox, oy, oz, dx, dy, dz, a, inv_a):
        t, ok = sweep_t(ox, oy, oz, dx, dy, dz, a, inv_a, cols)
        r = t.shape[0]
        chunk_best = t.view(r, n_chunks, chunk).amin(2)
        before = torch.cat([torch.full_like(chunk_best[:, :1], BIG),
                            chunk_best.cummin(1).values[:, :-1]], 1)
        adm = chunk_admits_plain(b, ox, oy, oz, dx, dy, dz, a, inv_a, before)
        near = (ok & live).view(r, n_chunks, chunk).sum(2)
        tally.add_(torch.stack([adm.sum(), (adm * live_per_chunk).sum(), (adm * near).sum()]))
        return winner_of(t, attrs)

    return sweep


def mega_walk_sample_plain(scene_pack, attrs, bounds, chunk_len, cam_row, *, bounce_seed: int,
                           cam_seed: int, rid_base: int, pix0: int, n_valid: int, n_cap: int,
                           w: int, max_depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the walk render on any device: the dense plain
    render over the slots (chunk_len is not needed: padding slots never
    hit).  Returns (colors [n_cap, 3] f32, stats [4] int64, STATS)."""
    cols = scene_pack.t()
    tally = torch.zeros(3, dtype=torch.int64, device=cols.device)
    colors, bounces = mega_render_plain(
        cols, attrs, cam_row, bounce_seed=bounce_seed, cam_seed=cam_seed, rid_base=rid_base,
        pix0=pix0, n_valid=n_valid, n_cap=n_cap, w=w, max_depth=max_depth,
        sweep=walk_sweep(cols, attrs, bounds, chunk_len.shape[0], tally))
    return colors, torch.cat([bounces, tally])


class WalkOut(NamedTuple):
    tape: torch.Tensor     # [max_depth, R, 32] f32, rows < lengths written; idx = slot
    lengths: torch.Tensor  # [R] int32 rows per ray
    colors: torch.Tensor   # [R, 3] f32
    stats: torch.Tensor    # [4] int64, STATS
    # [2] int64 WARP_STATS of the kernel; None from the plain version
    warp_stats: Optional[torch.Tensor] = None


def mega_walk_forward_camera_plain(scene_pack, attrs, bounds, chunk_len, cam_row, *,
                                   bounce_seed: int, cam_seed: int, pix0: int, n_valid: int,
                                   w: int, max_depth: int) -> WalkOut:
    """Plain version of the recording walk on any device: the plain
    recording forward over the slots; pixels pix0 + arange(n_valid), rid =
    the pixel."""
    cols = scene_pack.t()
    tally = torch.zeros(3, dtype=torch.int64, device=cols.device)
    out = mega_forward_camera_plain(
        cols, attrs, cam_row, None, bounce_seed=bounce_seed, cam_seed=cam_seed, pix0=pix0,
        n_valid=n_valid, w=w, max_depth=max_depth,
        sweep=walk_sweep(cols, attrs, bounds, chunk_len.shape[0], tally))
    return WalkOut(out.tape, out.lengths, out.colors, torch.cat([out.bounces, tally]))


def check_pack(scene_pack, attrs, bounds, chunk_len, device) -> Tuple[int, int, int]:
    """Check the pack operands of a walk kernel (CUDA on `device`,
    contiguous, float32 [n_slots, 4], [11, n_slots], [>= n_chunks, 4] and
    int32 [n_chunks], n_slots a multiple of n_chunks); returns (n_slots,
    chunk, n_chunks)."""
    n, n_chunks = scene_pack.shape[0], chunk_len.shape[0]
    for name, x, dtype in (("scene_pack", scene_pack, torch.float32),
                           ("attrs", attrs, torch.float32), ("bounds", bounds, torch.float32),
                           ("chunk_len", chunk_len, torch.int32)):
        if x.device.type != "cuda" or x.device != device or x.dtype != dtype:
            raise ValueError(f"{name} must be a CUDA {dtype} tensor on the pack's device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (tuple(scene_pack.shape) != (n, 4) or tuple(attrs.shape) != (A_ROWS, n)
            or bounds.dim() != 2 or bounds.shape[1] != 4 or bounds.shape[0] < n_chunks
            or chunk_len.dim() != 1 or n_chunks < 1 or n % n_chunks):
        raise ValueError(f"bad walk operands: scene_pack {tuple(scene_pack.shape)}, attrs "
                         f"{tuple(attrs.shape)}, bounds {tuple(bounds.shape)}, chunk_len "
                         f"{tuple(chunk_len.shape)}")
    return n, n // n_chunks, n_chunks


def _check_walk_args(scene_pack, attrs, bounds, chunk_len, cam_row) -> Tuple[int, int, int]:
    """check_pack on the pack's device, and the camera row (CUDA float32,
    contiguous, [24]); returns (n_slots, chunk, n_chunks)."""
    shape = check_pack(scene_pack, attrs, bounds, chunk_len, scene_pack.device)
    if (cam_row.device != scene_pack.device or cam_row.dtype != torch.float32
            or tuple(cam_row.shape) != (CAM_ROW,) or not cam_row.is_contiguous()):
        raise ValueError("cam_row must be a contiguous CUDA float32 tensor of shape "
                         f"({CAM_ROW},) on the pack's device")
    return shape


def _lib():
    lib = _build.load("mega_walk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mega_walk_render_launch.argtypes = [p, p, p, p, i, i, i, p, i, i, ctypes.c_uint, i, i,
                                            i, i, p, p, i, p]
    lib.mega_walk_record_launch.argtypes = [p, p, p, p, i, i, i, p, i, i, i, i, i, i, p, p, p,
                                            p, i, p]
    lib.mega_walk_render_launch.restype = lib.mega_walk_record_launch.restype = i
    return lib


def _counts(dev) -> torch.Tensor:
    """The [7] int64 counters a walk launch adds to (csrc/mega_walk.cu):
    bounces, warp steps, the ray counter, chunks admitted, slot tests,
    near tests and the warps' slot tests."""
    return torch.zeros(7, dtype=torch.int64, device=dev)


def _stats(counts: torch.Tensor) -> torch.Tensor:
    """The launch's STATS, in the plain versions' order."""
    return torch.cat((counts[0:1], counts[3:6]))


def _warp_stats(counts: torch.Tensor) -> torch.Tensor:
    """[2] int64: WARP_STATS (counters 1 and 6)."""
    return counts[1::5]


def _grid(dev, record: bool, grid: Optional[int]) -> int:
    return grid or _build.occupancy_grid("mega_walk", "mega_walk_blocks_per_sm", dev,
                                         int(record))


def mega_walk_sample_cuda(scene_pack, attrs, bounds, chunk_len, cam_row, *, bounce_seed: int,
                          cam_seed: int, rid_base: int, pix0: int, n_valid: int, n_cap: int,
                          w: int, max_depth: int, grid: Optional[int] = None,
                          with_warp_stats: bool = False):
    """Launch the render instantiation of csrc/mega_walk.cu on the current
    stream (no sync).  Same arguments and results as
    mega_walk_sample_plain; the stats are counted by the kernel.  grid: the
    most blocks of the persistent kernel (by default as many as fit the
    card at once; 1 makes one block trace every ray).  with_warp_stats:
    also return the [2] int64 WARP_STATS, for lane_use and
    sweep_lane_use."""
    n, chunk, n_chunks = _check_walk_args(scene_pack, attrs, bounds, chunk_len, cam_row)
    if not 0 <= n_valid <= n_cap or n_cap < 1:
        raise ValueError(f"need 0 <= n_valid <= n_cap, n_cap >= 1, got {n_valid}, {n_cap}")
    dev = scene_pack.device
    n_work = n_valid if max_depth > 0 else 0  # rows past n_work are black
    colors = torch.empty(n_cap, 3, dtype=torch.float32, device=dev)
    if n_work < n_cap:
        colors[n_work:].zero_()
    counts = _counts(dev)
    err = _lib().mega_walk_render_launch(
        scene_pack.data_ptr(), attrs.data_ptr(), bounds.data_ptr(), chunk_len.data_ptr(), n,
        chunk, n_chunks, cam_row.data_ptr(), wrap_i32(bounce_seed), wrap_i32(cam_seed),
        rid_base & _MASK32, pix0, n_work, w, max_depth, colors.data_ptr(), counts.data_ptr(),
        _grid(dev, False, grid), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mega_walk_render_launch")
    mega_walk_sample_cuda.launches += 1
    if with_warp_stats:
        return colors, _stats(counts), _warp_stats(counts)
    return colors, _stats(counts)


mega_walk_sample_cuda.launches = 0


def mega_walk_forward_camera_cuda(scene_pack, attrs, bounds, chunk_len, cam_row, *,
                                  bounce_seed: int, cam_seed: int, pix0: int, n_valid: int,
                                  w: int, max_depth: int, grid: Optional[int] = None) -> WalkOut:
    """Launch the record instantiation of csrc/mega_walk.cu on the current
    stream (no sync).  Same arguments and results as
    mega_walk_forward_camera_plain, and the kernel's WARP_STATS; grid as
    mega_walk_sample_cuda's."""
    n, chunk, n_chunks = _check_walk_args(scene_pack, attrs, bounds, chunk_len, cam_row)
    if n_valid < 1 or max_depth < 1:
        raise ValueError(f"need n_valid >= 1 and max_depth >= 1, got {n_valid}, {max_depth}")
    dev = scene_pack.device
    tape = torch.empty(max_depth, n_valid, TAPE_COLS, dtype=torch.float32, device=dev)
    lengths = torch.empty(n_valid, dtype=torch.int32, device=dev)
    colors = torch.empty(n_valid, 3, dtype=torch.float32, device=dev)
    counts = _counts(dev)
    err = _lib().mega_walk_record_launch(
        scene_pack.data_ptr(), attrs.data_ptr(), bounds.data_ptr(), chunk_len.data_ptr(), n,
        chunk, n_chunks, cam_row.data_ptr(), wrap_i32(bounce_seed), wrap_i32(cam_seed), pix0,
        n_valid, w, max_depth, tape.data_ptr(), lengths.data_ptr(), colors.data_ptr(),
        counts.data_ptr(), _grid(dev, True, grid), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mega_walk_record_launch")
    mega_walk_forward_camera_cuda.launches += 1
    return WalkOut(tape, lengths, colors, _stats(counts), _warp_stats(counts))


mega_walk_forward_camera_cuda.launches = 0


# The walk's tally: per device, the STATS of every launch through
# mega_walk_sample and mega_walk_forward_camera summed on that device (an
# add queued beside the launch: no host sync), with the chunks of the last
# pack counted on the host.  walk_tally reads and resets it.
_tally: Dict[torch.device, list] = {}


def _tally_add(stats: torch.Tensor, n_chunks: int) -> None:
    entry = _tally.setdefault(stats.device, [torch.zeros_like(stats), 0])
    entry[0].add_(stats)
    entry[1] = n_chunks


def walk_tally() -> Optional[Dict[str, int]]:
    """The walk's counts since the last call, then reset: the STATS summed
    over every render and record launch on every device, and "chunks", the
    chunk count of the last pack launched.  None when nothing was launched.
    Reads each device once."""
    if not _tally:
        return None
    entries = list(_tally.values())
    _tally.clear()
    total = sum(e[0].cpu() for e in entries)
    return {**dict(zip(STATS, (int(x) for x in total))), "chunks": entries[-1][1]}


def mega_walk_sample(scene_pack, attrs, bounds, chunk_len, cam_row,
                     **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image sample on the walk: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  The launch's STATS join the tally."""
    run = mega_walk_sample_plain if scene_pack.device.type == "cpu" else mega_walk_sample_cuda
    out = run(scene_pack, attrs, bounds, chunk_len, cam_row, **kw)
    _tally_add(out[1], chunk_len.shape[0])
    return out


def mega_walk_forward_camera(scene_pack, attrs, bounds, chunk_len, cam_row, **kw) -> WalkOut:
    """The recording walk: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  The launch's STATS join the tally."""
    run = (mega_walk_forward_camera_plain if scene_pack.device.type == "cpu"
           else mega_walk_forward_camera_cuda)
    out = run(scene_pack, attrs, bounds, chunk_len, cam_row, **kw)
    _tally_add(out.stats, chunk_len.shape[0])
    return out


def _pack_args(pack: WalkPack, camera: Camera, device):
    dev = resolve_device(device)
    p = pack.to(dev)
    cam_row = camera_scalar_row(camera).to(dev).contiguous()
    return (p.scene_pack, p.attrs, p.bounds, p.chunk_len, cam_row)


def mega_walk_colors(pack: WalkPack, camera: Camera, sample: int, bounce_seed: int,
                     cam_seed: int, *, n_cap: int = 0, pix0: int = 0,
                     n_valid: Optional[int] = None, n_global: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Per-pixel colors [n_cap, 3] of one image sample (mega_walk_kernel.py:
    789), with mega_render_colors' contract: n_cap=0 means the whole
    image; a shard passes its capacity, first global pixel, real pixel
    count and the image's n_global."""
    n_cap = n_cap or camera.num_pixels
    n_valid = n_cap if n_valid is None else n_valid
    n_global = n_cap if n_global is None else n_global
    colors, _ = mega_walk_sample(
        *_pack_args(pack, camera, device), bounce_seed=bounce_seed, cam_seed=cam_seed,
        rid_base=(sample * n_global) & _MASK32, pix0=pix0, n_valid=n_valid, n_cap=n_cap,
        w=camera.image_width, max_depth=camera.max_depth)
    return colors


def render_wavefront_sum_mega_walk(pack: WalkPack, camera: Camera, spp: int, bounce_seed: int,
                                   cam_seed: int, device=None) -> torch.Tensor:
    """Color sum [n_pix, 3] over samples 0..spp-1 on the walk
    (mega_walk_kernel.py:857), one kernel launch per sample, summed in
    sample order: at equal scene content, render_wavefront_sum_mega's sum
    bit for bit."""
    args = _pack_args(pack, camera, device)
    n = camera.num_pixels
    acc = None
    for s in range(spp):
        colors, _ = mega_walk_sample(
            *args, bounce_seed=bounce_seed, cam_seed=cam_seed, rid_base=(s * n) & _MASK32,
            pix0=0, n_valid=n, n_cap=n, w=camera.image_width, max_depth=camera.max_depth)
        acc = colors if acc is None else acc + colors
    return acc
