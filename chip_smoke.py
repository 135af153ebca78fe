"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, drives the
two main paths through their entry points on the RTiOW final scene at
1200x675, depth 50 (the progressive forward render, with resume and the
CLI; and the scene-gradient training step, with three Adam steps), and
prints one JSON line of kernel numbers and, last, one JSON line with the
device.  Any failed phase raises, so the exit code is nonzero and no
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
KERNELS = ("mega_render", "mega_forward", "mega_walk_bwd")
SOURCE = "distributed_raytracer_tpu_torch/csrc/{}.cu"
REPLACES = {
    "mega_render": "distributed_raytracer_tpu/ops/pallas/mega_render_kernel.py:179",
    "mega_forward": "distributed_raytracer_tpu/ops/pallas/mega_kernel.py:102",
    "mega_walk_bwd": "distributed_raytracer_tpu/ops/pallas/mega_walk_bwd_kernel.py:59",
}
NO_LIBRARY = {  # why library_ms is null
    "mega_render": "no single PyTorch call computes a path-traced image sample",
    "mega_forward": "no single PyTorch call computes a recording path-traced sample",
    "mega_walk_bwd": "no single PyTorch call computes the reverse walk of a bounce tape",
}
FP32_LANES_PER_SM = 128      # Hopper SM: 4 partitions x 32 FP32 lanes
# FP32 operations of one ray x sphere test in the sweep (bounce.cuh
# sweep_winner): oc 3, h 5, c_q 6, disc 3, the compare 1; and the more a
# test whose discriminant is not negative does: sqrt, the two roots (2
# each), three compares
FLOPS_PER_TEST = 18
FLOPS_PER_NEAR_TEST = 8
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
BOUNCE_SEED, CAM_SEED = 123456, 987654
# FP32 operations of one forward evaluation of the replay bounce
# (csrc/local_f.cuh, counted from the code: + - * / sqrt rsqrt each one;
# a refraction is counted as the mean of its reflect and refract arms),
# by the row's case; one reverse evaluation (the value and its adjoint)
# is counted as REVERSE_FACTOR times that
LOCAL_F_FLOPS = {"miss": 26, 0: 52, 1: 83, 2: 102, 3: 46, 4: 49}
REVERSE_FACTOR = 3
# K8 against its plain version, each column of g_pm normalized by its max:
# the same VJP by forward mode (kernel) and reverse mode (autograd), summed
# in another order (tests/test_mega_bwd.py:104)
K8_BAND = 1e-4
# the same at the main path (depth 50), where the f32 rounding of the two
# walks reaches about 4.5e-4 of the big glass sphere's ior column (its
# entry sums per-ray terms of both signs, many far larger than the sum);
# both walks stand 7.3e-3 to 7.8e-3 from the same walk in float64 there
# (the referee below), and the kernel's atomic order alone moves it 1e-6
K8_MAIN_BAND = 1e-3


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


def cuda_timed(fn):
    """(fn(), its milliseconds by CUDA events) for one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(name: str, got: torch.Tensor, want: torch.Tensor):
    """Per-pixel max abs difference stats between two [P, 3] images."""
    d = (got - want).abs().max(dim=1).values
    stats = dict(max=float(d.max()), mean=float((got - want).abs().mean()),
                 over_5e4=int((d > 5e-4).sum()), pixels=int(d.numel()))
    log(f"[check] {name}: max {stats['max']:.3e} mean {stats['mean']:.3e} "
        f"pixels over 5e-4: {stats['over_5e4']}/{stats['pixels']}")
    return stats


def written_rows(out) -> torch.Tensor:
    """The tape rows a recording forward wrote, [rows, 32], depth-major."""
    depth = torch.arange(out.tape.shape[0], device=out.tape.device)[:, None]
    return out.tape[depth < out.lengths[None, :].long()]


def sweep_work(out, cols) -> dict:
    """The FP32 operations the sweeps of this run's rays need: every
    bounce on the tape tests its ray against every live sphere (a padding
    sphere, r2 = -1, never hits, so a sweep without it gives the same
    answer), at FLOPS_PER_TEST each, plus FLOPS_PER_NEAR_TEST for each test
    whose discriminant is not negative, counted here in the kernel's f32
    order."""
    rows = written_rows(out)
    live = cols[3] >= 0.0
    cx, cy, cz, r2 = (cols[k][live][None, :] for k in range(4))
    near = 0
    for chunk in rows.split(1 << 16):
        ox, oy, oz, dx, dy, dz = (chunk[:, k:k + 1] for k in range(6))
        a = dx * dx + dy * dy + dz * dz
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        h = dx * ocx + dy * ocy + dz * ocz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - r2
        near += int(((h * h - a * c_q) >= 0.0).sum())
    tests = rows.shape[0] * int(live.sum())
    return dict(tests=tests, near=near, live=int(live.sum()),
                flops=tests * FLOPS_PER_TEST + near * FLOPS_PER_NEAR_TEST)


def col_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-column max |got - want| over the spheres, normalized by the
    column's max |want|."""
    return (got - want).abs().max(dim=0).values / (want.abs().max(dim=0).values + 1e-8)


def walk_work(out, n_sph: int):
    """(FP32 operations, bytes) the reverse walk needs for this tape: one
    reverse evaluation of the replay bounce per row of every ray that
    finished (the others carry no cotangent), by the row's case; each such
    row read once, one flag word of every other ray, g_color, lengths and
    the [n + 1, 9] result."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk

    rows = written_rows(out)
    bits = rows.view(torch.int32)
    flags = bits[:, mk.T_FLG]
    ray = bits[:, mk.T_RAY].long()
    n_rays = out.lengths.shape[0]
    fin_ray = torch.zeros(n_rays, dtype=torch.bool, device=rows.device)
    fin_ray[ray[(flags & mk.F_FIN) != 0]] = True
    used = fin_ray[ray]
    hit = (flags & mk.F_HIT) != 0
    mt = rows[:, mk.T_MT]
    flops = int((used & ~hit).sum()) * LOCAL_F_FLOPS["miss"]
    for code in range(5):
        flops += int((used & hit & (mt == code)).sum()) * LOCAL_F_FLOPS[code]
    n_used = int(used.sum())
    other = int(((out.lengths > 0) & ~fin_ray).sum())
    nbytes = n_used * 128 + other * 4 + n_rays * (12 + 4) + (n_sph + 1) * 9 * 4
    return flops * REVERSE_FACTOR, nbytes, n_used


def check_gradient_path(dev, presets, final, cam_main, k5_main) -> dict:
    """Phases 6-8: the recording forward (K6) against the render kernel
    and its plain version, the reverse walk (K8) against its plain
    version, and the training step at full width."""
    from distributed_raytracer_tpu_torch import image_loss, make_tape_camera_tracer
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk

    def fwd_args(scene, cam):
        cols, attrs, cam_row = mrk.prepare(scene, cam, dev)
        return (cols, attrs, cam_row, None), dict(
            bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED, pix0=0, n_valid=cam.num_pixels,
            w=cam.image_width, max_depth=cam.max_depth)

    def same_tape(label, got, want):
        """The two recording forwards wrote the same rows, lengths and
        colors, bit for bit; returns the max abs difference of the float
        columns."""
        require(torch.equal(got.lengths, want.lengths), f"{label}: K6 lengths differ")
        gr, wr = written_rows(got), written_rows(want)
        err = max(float((gr[:, :mk.T_IDX] - wr[:, :mk.T_IDX]).abs().max()),
                  float((got.colors - want.colors).abs().max()))
        same = (torch.equal(gr.view(torch.int32), wr.view(torch.int32))
                and torch.equal(got.colors, want.colors))
        log(f"[k6] {label}: tape rows {gr.shape[0]:,}, max abs err {err:.3e}, rows and colors "
            f"equal bit for bit {same}")
        require(same, f"{label}: K6 differs from plain")
        return err

    # --- phase 6: K6 against K5, then against its plain version ---
    args_main, kw_main = fwd_args(final, cam_main)
    out_main = mk.mega_forward_camera_cuda(*args_main, **kw_main)
    torch.cuda.synchronize()
    k5_err = float((out_main.colors - k5_main).abs().max())
    log(f"[k6] final 1200x675 depth 50: colors vs the render kernel, sample 0: max abs err "
        f"{k5_err:.3e}")
    require(torch.equal(out_main.colors, k5_main), "K6 colors differ from K5's")
    # the main-path shape against the plain version (timed here)
    plain_main, k6_plain_ms = cuda_timed(
        lambda: mk.mega_forward_camera_plain(*args_main, **kw_main))
    k6_err = same_tape("final 1200x675 depth 50", out_main, plain_main)
    del plain_main
    c2_scene, c2_cam = presets.config2()
    shapes = [("config2 400x225 depth 50", c2_scene, c2_cam),
              ("final 1200x675 depth 8", final, cam_main.replace(max_depth=8))]
    tapes = []
    for label, scene, cam in shapes:
        args, kw = fwd_args(scene, cam)
        got = mk.mega_forward_camera_cuda(*args, **kw)
        want = mk.mega_forward_camera_plain(*args, **kw)
        torch.cuda.synchronize()
        same_tape(label, got, want)
        tapes.append((label, scene, got))

    # --- phase 7: K8 against its plain version on the same K6 tapes ---
    n_pix, n_sph = cam_main.num_pixels, final.num_spheres

    def k8_check(label, out, n, band, referee=False):
        g = torch.randn(out.lengths.shape[0], 3,
                        generator=torch.Generator().manual_seed(3)).to(dev)
        got = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n)
        again = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n)
        want, plain_ms = cuda_timed(lambda: wbk.mega_walk_backward_plain(out.tape, out.lengths,
                                                                         g, n))
        err = col_err(got[:n], want[:n])
        fmt = lambda e: [f"{x:.2e}" for x in e.tolist()]
        log(f"[k8] {label}: per-column normalized err {fmt(err)}, run-to-run "
            f"{float(col_err(again[:n], got[:n]).max()):.2e} normalized "
            f"({float((got - again).abs().max()):.3e} abs), plain {plain_ms:.1f} ms")
        if referee:  # both f32 walks against the same walk in float64
            exact = wbk.mega_walk_backward_plain(out.tape, out.lengths, g, n,
                                                 dtype=torch.float64)[:n]
            log(f"[k8] {label}: vs the float64 walk, kernel {fmt(col_err(got[:n].double(), exact))}"
                f", plain {fmt(col_err(want[:n].double(), exact))}")
        require(bool(torch.isfinite(got).all()), f"{label}: K8 gradients not finite")
        require(float(err.max()) < band, f"{label}: K8 vs plain {float(err.max()):.3e}")
        return float((got[:n] - want[:n]).abs().max()), float(err.max()), plain_ms, g

    for label, scene, out in tapes:
        k8_check(label, out, scene.num_spheres, K8_BAND)
    del tapes
    # the main-path shape: the numbers the kernel line reports
    k8_err, k8_norm_err, k8_plain_ms, g_main = k8_check("final 1200x675 depth 50", out_main,
                                                        n_sph, K8_MAIN_BAND, referee=True)

    # --- phase 8: the training step at full width, through the entry points ---
    tracer = make_tape_camera_tracer(cam_main, BOUNCE_SEED, CAM_SEED, iota_pix=True)
    ids = torch.arange(n_pix)
    target = torch.zeros(n_pix, 3, device=dev)
    p = {k: v.to(dev).clone().requires_grad_() for k, v in final.diff_params().items()}
    scene_p = final.with_diff_params(p)
    mk.mega_forward_camera_cuda.launches = 0
    wbk.mega_walk_backward_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    loss = image_loss(tracer(scene_p, ids), target)
    loss.backward()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"mega_forward": mk.mega_forward_camera_cuda.launches,
                "mega_walk_bwd": wbk.mega_walk_backward_cuda.launches}
    log(f"[train] final 1200x675 depth 50, {n_pix:,} rays: loss {loss.item():.6f}, first "
        f"step {wall * 1e3:.1f} ms wall, launches {launches}")
    require(all(v >= 1 for v in launches.values()), f"the training step skipped a kernel: {launches}")
    live = final.radii.to(dev) > 0
    for k, v in p.items():
        require(bool(torch.isfinite(v.grad).all()), f"{k} gradient not finite")
        require(float(v.grad[~live].abs().max()) == 0.0, f"{k} gradient nonzero on padding")
    for k in ("centers", "albedo"):
        require(float(p[k].grad[live].abs().max()) > 0.0, f"{k} gradient is zero")
    log(f"[train] grads finite; padding spheres ({int((~live).sum())}) zero; max |grad| "
        + ", ".join(f"{k} {float(v.grad.abs().max()):.3e}" for k, v in p.items()))

    def step():
        for v in p.values():
            v.grad = None
        image_loss(tracer(scene_p, ids), target).backward()

    step_ms = cuda_ms(step, 3)
    log(f"[time] fwd+bwd step {step_ms:.3f} ms ({n_pix / step_ms * 1e3:,.0f} rays/s)")

    # the kernels alone at the main-path shape
    k6_ms = cuda_ms(lambda: mk.mega_forward_camera_cuda(*args_main, **kw_main), 3)
    k8_ms = cuda_ms(lambda: wbk.mega_walk_backward_cuda(out_main.tape, out_main.lengths,
                                                         g_main, n_sph), 3)
    rows = int(out_main.lengths.sum())
    sweep = sweep_work(out_main, args_main[0])
    k6_bytes = (rows * 128 + n_pix * (12 + 4) + 4 * n_sph * 4 + 11 * n_sph * 4 + 24 * 4 + 8)
    k8_flops, k8_bytes, k8_rows = walk_work(out_main, n_sph)
    log(f"[time] K6 {k6_ms:.3f} ms (plain {k6_plain_ms:.1f} ms), K8 {k8_ms:.3f} ms (plain "
        f"{k8_plain_ms:.1f} ms) at the main path; tape {out_main.tape.numel() * 4:,} B "
        f"allocated, {rows * 128:,} B written ({rows:,} rows, {rows / n_pix:.4f} per ray); "
        f"K8 reads {k8_rows:,} rows")
    log(f"[bound] sweep: {sweep['tests']:,} ray x live-sphere tests ({sweep['live']} live "
        f"spheres), {sweep['near']:,} with disc >= 0 ({sweep['near'] / sweep['tests']:.4%}), "
        f"{sweep['flops']:,} FP32 operations")

    # three Adam steps on albedo alone, toward the true scene's image
    albedo = (final.albedo.to(dev) * 0.8).requires_grad_()
    truth = mrk.mega_render_colors(final, cam_main, 0, BOUNCE_SEED, CAM_SEED, device=dev)
    opt = torch.optim.Adam([albedo], lr=0.01)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = image_loss(tracer(final.with_diff_params({"albedo": albedo}), ids), truth)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        log(f"[train] Adam step {len(losses)}: loss {losses[-1]:.6e}")
    require(losses[-1] < losses[0], f"Adam did not lower the loss: {losses}")

    return {
        "mega_forward": dict(launches=launches["mega_forward"], max_abs_err=k6_err, ms=k6_ms,
                             plain_ms=k6_plain_ms, flops=sweep["flops"], bytes=k6_bytes),
        "sweep": sweep,
        "mega_walk_bwd": dict(launches=launches["mega_walk_bwd"], max_abs_err=k8_err, ms=k8_ms,
                              plain_ms=k8_plain_ms, flops=k8_flops, bytes=k8_bytes,
                              max_norm_err=k8_norm_err),
        "record": dict(step_ms=step_ms, rays_per_s=n_pix / step_ms * 1e3, first_step_wall_ms=wall
                       * 1e3, adam_losses=losses, tape_bytes_allocated=out_main.tape.numel() * 4,
                       tape_bytes_written=rows * 128, tape_rows=rows, k8_rows=k8_rows,
                       sweep=sweep, k8_max_norm_err=k8_norm_err),
    }


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
    reports = _build.build(*KERNELS)
    log(f"[build] {len(KERNELS)} sources built in parallel in {time.time() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")
    dev = torch.device("cuda")

    def both(scene, cam, sample=0, bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED):
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
    n_pix = cam_main.num_pixels
    bytes_moved = (cols.numel() + attrs.numel() + cam_row.numel() + 3 * n_pix) * 4 + 8
    log(f"[time] kernel {ms:.3f} ms/sample ({n_pix / ms * 1e3:,.0f} rays/s), "
        f"plain {plain_ms:.1f} ms, mean bounces/ray {kb / n_pix:.4f}")

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

    # --- phases 6-8: the scene-gradient path (K6, K8) ---
    grad = check_gradient_path(dev, presets, final, cam_main, k)
    peak = fp32_peak_flops()

    # --- phase 9: the kernel line, then the device line last ---
    # K5 at the main-path shape traced the rays K6 recorded (sample 0, the
    # same seeds: equal colors and bounce counts), so it needs the same sweeps
    require(grad["sweep"]["tests"] == kb * grad["sweep"]["live"], "K5 and K6 bounce counts differ")
    ops_s = grad["sweep"]["flops"] / peak
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    kernels = [dict(
        name="mega_render", route="cuda", source=SOURCE.format("mega_render"),
        replaces=REPLACES["mega_render"], launches=launches, max_abs_err=st_main["max"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(ops_s, bytes_s) * 1e3,
        bound_by="operations" if ops_s >= bytes_s else "bytes", library_ms=None,
        library_note=NO_LIBRARY["mega_render"],
    )]
    for name in ("mega_forward", "mega_walk_bwd"):
        g = grad[name]
        ops_s = g["flops"] / peak
        bytes_s = g["bytes"] / HBM_BYTES_PER_S
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE.format(name), replaces=REPLACES[name],
            launches=g["launches"], max_abs_err=g["max_abs_err"], ms=g["ms"],
            plain_ms=g["plain_ms"], bound_ms=max(ops_s, bytes_s) * 1e3,
            bound_by="operations" if ops_s >= bytes_s else "bytes", library_ms=None,
            library_note=NO_LIBRARY[name]))
        if "max_norm_err" in g:  # g_pm's columns span orders of magnitude
            kernels[-1]["max_norm_err"] = g["max_norm_err"]
    for kd in kernels:
        log(f"[kernel] {kd['name']}: {kd['ms']:.3f} ms, bound {kd['bound_ms']:.4f} ms "
            f"({kd['bound_by']}), plain {kd['plain_ms']:.1f} ms, launches {kd['launches']}, "
            f"max_abs_err {kd['max_abs_err']:.3e}")
    if args.record:
        record = dict(card=smi, kernels=kernels, mean_bounces_per_ray=kb / n_pix,
                      main_path_ms_per_sample=wall * 1e3 / 4, gradient_path=grad["record"],
                      seconds=time.time() - t_start)
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record, indent=1))
    log(f"[time] whole run {time.time() - t_start:.1f} s")
    log(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
