"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, drives the
main path (the progressive forward render of the RTiOW final scene at
1200x675, depth 50) through its entry points, checks resume and the CLI,
and prints one JSON line of kernel numbers and, last, one JSON line with
the device.  Any failed phase raises, so the exit code is nonzero and no
result line is printed.  Without a CUDA card it exits with code 2.

    python3 chip_smoke.py --record out/chip_smoke.json

also writes the run's numbers to that file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPLACES = "distributed_raytracer_tpu/ops/pallas/mega_render_kernel.py:179"
SOURCE = "distributed_raytracer_tpu_torch/csrc/mega_render.cu"
FP32_LANES_PER_SM = 128      # Hopper SM: 4 partitions x 32 FP32 lanes
FLOPS_PER_TEST = 20          # FP32 operations per ray x sphere test
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate


class SmokeFailure(RuntimeError):
    pass


def require(cond, what) -> None:
    if not cond:
        raise SmokeFailure(str(what))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def fp32_peak_flops() -> float:
    """SMs x 128 FP32 lanes x 2 (an FMA) x the SM clock."""
    props = torch.cuda.get_device_properties(0)
    khz = getattr(props, "clock_rate", None)
    if khz:
        hz, src = khz * 1e3, "device properties"
    else:
        hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
        src = "nvidia-smi clocks.max.sm"
    peak = props.multi_processor_count * FP32_LANES_PER_SM * 2 * hz
    log(f"fp32 peak {peak / 1e12:.2f} TFLOP/s ({props.multi_processor_count} SMs, "
        f"{hz / 1e6:.0f} MHz from {src})")
    return peak


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got: torch.Tensor, want: torch.Tensor):
    """Per-pixel max abs difference stats between two [P, 3] images."""
    d = (got - want).abs().max(dim=1).values
    stats = dict(max=float(d.max()), mean=float((got - want).abs().mean()),
                 over_5e4=int((d > 5e-4).sum()), pixels=int(d.numel()))
    log(f"[check] {name}: max {stats['max']:.3e} mean {stats['mean']:.3e} "
        f"pixels over 5e-4: {stats['over_5e4']}/{stats['pixels']}")
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, help="write the run's numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.kernels import _build
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.render.image import read_ppm
    from distributed_raytracer_tpu_torch.render.progressive import (
        AccumState,
        render_progressive,
    )

    t_start = time.time()
    smi = nvidia_smi("name,power.limit")
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # --- phase 1: build every kernel from the checkout's sources ---
    t0 = time.time()
    report = _build.build("mega_render")
    log(f"[build] csrc built in {time.time() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] mega_render: {line.strip()}")
    dev = torch.device("cuda")

    def both(scene, cam, sample=0, bounce_seed=123456, cam_seed=987654):
        cols, attrs, cam_row = mrk.prepare(scene, cam, dev)
        kw = dict(bounce_seed=bounce_seed, cam_seed=cam_seed,
                  rid_base=sample * cam.num_pixels, pix0=0, n_valid=cam.num_pixels,
                  n_cap=cam.num_pixels, w=cam.image_width, max_depth=cam.max_depth)
        k_col, k_b = mrk.mega_render_cuda(cols, attrs, cam_row, **kw)
        p_col, p_b = mrk.mega_render_plain(cols, attrs, cam_row, **kw)
        torch.cuda.synchronize()
        return k_col, int(k_b), p_col, int(p_b), (cols, attrs, cam_row, kw)

    # --- phase 2: kernel vs plain version on the card ---
    c2_scene, c2_cam = presets.config2()
    k, kb, p, pb, _ = both(c2_scene, c2_cam)
    st = compare("config2 400x225 depth 50", k, p)
    require(st["mean"] < 5e-6 and st["over_5e4"] <= 0.001 * st["pixels"], st)
    require(bool(torch.isfinite(k).all()), "config2 kernel image is not finite")

    final = presets.rtiow_final_scene(seed=0, pad_to=512)
    cam_main = presets.final_scene_camera(1200)
    k, kb, p, pb, _ = both(final, cam_main.replace(max_depth=1))
    st = compare("final 1200x675 depth 1", k, p)
    require(st["max"] < 1e-6, st)
    k, kb, p, pb, _ = both(final, cam_main.replace(max_depth=8))
    st = compare("final 1200x675 depth 8", k, p)
    require(st["over_5e4"] <= 0.02 * st["pixels"] and st["mean"] < 1.5e-3, st)

    # the main-path shape: depth 50; the bounce counts must agree too
    k, kb, p, pb, (cols, attrs, cam_row, kw) = both(final, cam_main)
    st_main = compare("final 1200x675 depth 50", k, p)
    require(st_main["over_5e4"] <= 0.02 * st_main["pixels"] and st_main["mean"] < 1.5e-3, st_main)
    log(f"[check] bounces kernel {kb} plain {pb}")
    require(abs(kb - pb) <= 0.001 * pb, (kb, pb))

    # --- timing at the main-path shape ---
    mrk.mega_render_cuda(cols, attrs, cam_row, **kw)  # warm
    ms = cuda_ms(lambda: mrk.mega_render_cuda(cols, attrs, cam_row, **kw), 10)
    plain_ms = cuda_ms(lambda: mrk.mega_render_plain(cols, attrs, cam_row, **kw), 2)
    n_pix, n_sph = cam_main.num_pixels, final.num_spheres
    tests = kb * n_sph
    ops_s = tests * FLOPS_PER_TEST / fp32_peak_flops()
    bytes_moved = (cols.numel() + attrs.numel() + cam_row.numel() + 3 * n_pix) * 4 + 8
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    log(f"[time] kernel {ms:.3f} ms/sample ({n_pix / ms * 1e3:,.0f} rays/s), "
        f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{tests:,} ray x sphere tests, {bytes_moved:,} B), "
        f"mean bounces/ray {kb / n_pix:.4f}")

    # --- phase 3: the main path through its entry points ---
    scene5, cam5 = presets.config5()
    mrk.mega_render_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    state = render_progressive(scene5, cam5, seed=0, spp=4, batch=4, engine="mega")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = mrk.mega_render_cuda.launches
    log(f"[main] render_progressive config5 1200x675 depth 50 spp 4: {wall * 1e3 / 4:.2f} "
        f"ms/sample wall, {4 * n_pix / wall:,.0f} rays/s, kernel launches {launches}")
    require(launches >= 1, "the main path did not launch the mega render kernel")
    img = state.mean_image()
    require(img.shape == (675, 1200, 3) and np.isfinite(img).all(),
            f"main-path image of shape {img.shape} is not a finite 675x1200x3 image")
    top = img[0, 600]
    require(top[2] > top[0], f"top-center pixel not bluish: {top}")
    log(f"[main] top-center pixel {top.tolist()}")

    ckpt = ROOT / "build" / "smoke_ckpt.npz"
    ckpt.parent.mkdir(exist_ok=True)
    if ckpt.exists():
        ckpt.unlink()
    whole = render_progressive(scene5, cam5, seed=7, spp=4, batch=2, engine="mega")
    render_progressive(scene5, cam5, seed=7, spp=2, batch=2, engine="mega",
                       checkpoint_path=str(ckpt))
    require(AccumState.load(str(ckpt)).samples_done == 2, "checkpoint does not hold 2 samples")
    resumed = render_progressive(scene5, cam5, seed=7, spp=4, batch=2, engine="mega",
                                 checkpoint_path=str(ckpt))
    require(resumed.samples_done == 4, "resumed render did not reach 4 samples")
    require(np.array_equal(resumed.raw_sum, whole.raw_sum), "resume is not bit-identical")
    log("[main] resumed 2+2 spp render equals the uninterrupted 4 spp render bit for bit")

    # --- phase 4: the CLI ---
    out_ppm = ROOT / "build" / "smoke.ppm"
    out_ppm.parent.mkdir(exist_ok=True)
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", "render",
         "--config", "config5", "--spp", "2", "--out", str(out_ppm)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    log(f"[cli] exit {r.returncode} in {time.time() - t0:.1f} s: "
        f"{r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ''}")
    require(r.returncode == 0, r.stderr[-4000:])
    require(read_ppm(str(out_ppm)).shape == (675, 1200, 3), "CLI PPM is not 1200x675")

    # --- phase 5: the kernel line, then the device line last ---
    kernels = [dict(
        name="mega_render", route="cuda", source=SOURCE, replaces=REPLACES,
        launches=launches, max_abs_err=st_main["max"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )]
    if args.record:
        record = dict(card=smi, kernels=kernels, mean_bounces_per_ray=kb / n_pix,
                      main_path_ms_per_sample=wall * 1e3 / 4, seconds=time.time() - t_start)
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record, indent=1))
    log(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
