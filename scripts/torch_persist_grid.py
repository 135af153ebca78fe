"""The persistent kernels of the PyTorch/CUDA port at grids of 1 to 4
blocks per SM, on one CUDA card.

    python3 scripts/torch_persist_grid.py [--record out.json]

Times each kernel by CUDA events (mean of 5 launches after one warm-up) at
grids of SMs x 1 .. 4 blocks, and prints its lane use (bounces, or rows
walked, over 32 x warp steps) beside each time; for K9 also the sweep lane
use (slot tests of admitted chunks over 32 x the slot-test rounds the
warps issued).  On the RTiOW final scene at 1200x675 depth 50: K5 and K6 in
camera mode (810,000 rays), K6 in ray mode on the ray-table tracer's
262,144 rays strided over the image, K8 on K6's tape (the dense training
step's backward) and K7 with ray grads on K6's ray-mode tape (the
ray-table step's backward).  On bench.py's 8,192-sphere field at 1024x576
depth 8: K9 render and record, and K8 on K9's tape (the walk step's
backward, 8,448 slots).  Then the reverse walks' feed order at the
occupancy grid: K8 on both tapes and K7 with the rays in the orders of
feed_orders (index order, an exact length order, the wrappers' default
mega_walk_bwd_kernel.longest_first, whose sort is timed apart, and two
coarser splits).  --kernels K9,K8 times only the kernels whose names
start so.  A
smaller grid holds fewer rays in flight, so its pools drain sooner after
the ray counter empties, but keeps fewer warps on each SM.  Exits with
code 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BOUNCE_SEED, CAM_SEED = 123456, 987654
RAY_TRACER_RAYS = 262144


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def feed_orders(lengths: torch.Tensor) -> dict:
    """The feed orders the probe compares, each an [R] int32 permutation:
    index order; the rays by descending length (a stable sort); the
    wrappers' default, mega_walk_bwd_kernel.longest_first (by descending
    ceil(log2(length)), so that rays of nearby lengths keep their index
    order); and the rays of at least 4 or 8 rows first, each part in index
    order."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk

    idx = torch.arange(lengths.shape[0], dtype=torch.int32, device=lengths.device)

    def first(key):
        return torch.sort(key, descending=True, stable=True).indices.to(torch.int32)

    return {"index": idx, "by exact length": first(lengths),
            "longest first by log2 length (the default)": wbk.longest_first(lengths),
            "4 rows or more first": first((lengths >= 4).to(torch.int32)),
            "8 rows or more first": first((lengths >= 8).to(torch.int32))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, help="write the numbers to this JSON file")
    ap.add_argument("--kernels", default="", help="comma-separated name prefixes (default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_persist_grid: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row
    from distributed_raytracer_tpu_torch.ops.kernels import mega_bwd_kernel as mbk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    final = presets.rtiow_final_scene(seed=0, pad_to=512)
    cam = presets.final_scene_camera(1200)
    n = cam.num_pixels
    cols, attrs, row = mrk.prepare(final, cam, dev)
    kw = dict(bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED, pix0=0, n_valid=n,
              w=cam.image_width, max_depth=cam.max_depth)
    ids = torch.arange(RAY_TRACER_RAYS, dtype=torch.int64, device=dev) * n // RAY_TRACER_RAYS
    o, d = mrk.camera_rays_host(row, ids, ids, CAM_SEED, cam.image_width)
    o, d = o.contiguous(), d.contiguous()

    def k5(grid):
        _, b, s = mrk.mega_render_cuda(cols, attrs, row, rid_base=0, n_cap=n, grid=grid,
                                       with_warp_steps=True, **kw)
        return b, s

    def k6(grid):
        out = mk.mega_forward_camera_cuda(cols, attrs, row, None, grid=grid, **kw)
        return out.bounces, out.warp_steps

    def k6_ray(grid):
        out = mk.mega_forward_cuda(cols, attrs, o, d, bounce_seed=BOUNCE_SEED,
                                   max_depth=cam.max_depth, grid=grid)
        return out.bounces, out.warp_steps

    # the walk: bench.py:317-322's field and camera (1024x576, depth 8)
    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    wcam = presets.make_camera(aspect_ratio=16.0 / 9.0, image_width=1024, samples_per_pixel=4,
                               max_depth=8, vfov=55.0, lookfrom=(0.0, 20.0, 60.0),
                               lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0), defocus_angle=0.0,
                               focus_dist=10.0)
    pack = mwk.walk_pack_for(field, wcam, chunk=256).to(dev)
    wn = wcam.num_pixels
    wargs = (pack.scene_pack, pack.attrs, pack.bounds, pack.chunk_len,
             camera_scalar_row(wcam).to(dev).contiguous())
    wkw = dict(bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED, pix0=0, n_valid=wn,
               w=wcam.image_width, max_depth=wcam.max_depth)

    def k9(grid):
        _, st, warp = mwk.mega_walk_sample_cuda(*wargs, rid_base=0, n_cap=wn, grid=grid,
                                                with_warp_stats=True, **wkw)
        return st[0], warp[0], st[2], warp[1]

    def k9_record(grid):
        out = mwk.mega_walk_forward_camera_cuda(*wargs, grid=grid, **wkw)
        return out.stats[0], out.warp_stats[0], out.stats[2], out.warp_stats[1]

    # the reverse walks' tapes, g_color from a seed: K6's (the dense step, K8),
    # K9's (the walk step, K8) and K6's in ray mode (the ray-table step, K7)
    tapes = {"dense": mk.mega_forward_camera_cuda(cols, attrs, row, None, **kw),
             "walk": mwk.mega_walk_forward_camera_cuda(*wargs, **wkw),
             "ray": mk.mega_forward_cuda(cols, attrs, o, d, bounce_seed=BOUNCE_SEED,
                                         max_depth=cam.max_depth)}
    g_color = {k: torch.randn(t.lengths.shape[0], 3,
                              generator=torch.Generator().manual_seed(3)).to(dev)
               for k, t in tapes.items()}

    def walk(name, which, order=None):
        """K7 or K8 (by name) on one tape: (rows walked, warp steps) of one launch."""
        tape, g = tapes[which], g_color[which]
        if name.startswith("K7"):  # with its ray grads, as the ray-table tracer runs it
            return lambda grid: mbk.mega_backward_cuda(
                cols, attrs, tape.tape, tape.lengths, g, final.num_spheres, grid=grid,
                order=order, with_stats=True)[-1]
        n_bins = pack.n_slots if which == "walk" else final.num_spheres
        return lambda grid: wbk.mega_walk_backward_cuda(
            tape.tape, tape.lengths, g, n_bins, ray_grads=which == "ray", grid=grid,
            order=order, with_stats=True)[-1]

    rows = []
    wanted = [k for k in args.kernels.split(",") if k]
    # K8 with ray grads on the ray-table tape reads the winner's parameters off
    # the tape where K7 reads them from the scene in shared memory
    walks = (("K8 dense tape", "dense"), ("K8 walk tape", "walk"), ("K7 ray tape", "ray"),
             ("K8 ray tape", "ray"))
    for name, fn in (("K5", k5), ("K6 camera", k6), ("K6 ray", k6_ray), ("K9 render", k9),
                     ("K9 record", k9_record), *((n, walk(n, w)) for n, w in walks)):
        if wanted and not any(name.startswith(k) for k in wanted):
            continue
        for per_sm in (1, 2, 3, 4):
            grid = sms * per_sm
            b, s, *sweep = fn(grid)
            ms = cuda_ms(lambda: fn(grid))
            lane = mk.lane_use(int(b), int(s))
            rows.append(dict(kernel=name, blocks_per_sm=per_sm, grid=grid, ms=ms, lane_use=lane))
            extra = ""
            if sweep:
                rows[-1]["sweep_lane_use"] = mk.sweep_lane_use(int(sweep[0]), int(sweep[1]))
                extra = f", sweep lane use {rows[-1]['sweep_lane_use']:.4f}"
            print(f"[grid] {name}: {per_sm} blocks per SM (grid {grid}): {ms:.3f} ms, lane use "
                  f"{lane:.4f}{extra}", flush=True)

    # the reverse walks' feed order, at the occupancy grid
    for name, which in walks:
        if wanted and not any(name.startswith(k) for k in wanted):
            continue
        lengths = tapes[which].lengths
        sort_ms = cuda_ms(lambda: wbk.longest_first(lengths))
        for label, order in feed_orders(lengths).items():
            fn = walk(name, which, order)
            b, s = fn(None)
            ms = cuda_ms(lambda: fn(None))
            lane = mk.lane_use(int(b), int(s))
            rows.append(dict(kernel=name, order=label, ms=ms, lane_use=lane, sort_ms=sort_ms))
            print(f"[order] {name}, rays fed {label} (the order given): {ms:.3f} ms, lane use "
                  f"{lane:.4f}; the sort alone {sort_ms:.3f} ms", flush=True)
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
