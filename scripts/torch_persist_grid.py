"""K5 and K6 of the PyTorch/CUDA port at persistent grids of 1 to 4 blocks
per SM, on one CUDA card.

    python3 scripts/torch_persist_grid.py [--record out.json]

On the RTiOW final scene at 1200x675 depth 50 (K5 and K6 in camera mode,
810,000 rays; K6 in ray mode on the ray-table tracer's 262,144 rays
strided over the image), times each kernel by CUDA events (mean of 5
launches after one warm-up) at grids of SMs x 1 .. 4 blocks of 256
threads, and prints its lane use (bounces / (32 x warp steps)) beside
each time.  A smaller grid holds fewer rays in flight, so its pools drain
sooner after the ray counter empties, but keeps fewer warps on each SM.
Exits with code 2 without a CUDA card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, help="write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_persist_grid: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk

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

    rows = []
    for name, fn in (("K5", k5), ("K6 camera", k6), ("K6 ray", k6_ray)):
        for per_sm in (1, 2, 3, 4):
            grid = sms * per_sm
            b, s = fn(grid)
            ms = cuda_ms(lambda: fn(grid))
            lane = mk.lane_use(int(b), int(s))
            rows.append(dict(kernel=name, blocks_per_sm=per_sm, grid=grid, ms=ms, lane_use=lane))
            print(f"[grid] {name}: {per_sm} blocks per SM (grid {grid}): {ms:.3f} ms, lane use "
                  f"{lane:.4f}", flush=True)
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
