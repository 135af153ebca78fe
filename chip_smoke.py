"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, drives the
two main paths through their entry points on the RTiOW final scene at
1200x675, depth 50 (the progressive forward render, with resume and the
CLI; and the scene-gradient training step, with three Adam steps), then
the walk engine's two on bench.py's 8,192-sphere field at 1024x576,
depth 8 (the walk training step, and the progressive render routed past
512 spheres), then the gradients through rays and the camera pose on the
final scene (the ray-table tracer on 262,144 rays strided over 1200x675,
and the pose tracer on all 810,000 pixels, depth 50), then the fused
wavefront engine (render_progressive(engine="fused"): dense on the final
scene at 1200x675 depth 50, culled on it and on the 8,192-sphere field at
1024x576 depth 8, with resume and the CLI), then the reference bounce's
two engines (render_progressive(engine="wavefront") with the closest-hit
kernel at 1200x675 depth 50, and over the culled field with the two
culled closest-hit kernels; render_image, the scan engine, at 1200x675
depth 50; the CLI on both), and prints one JSON line of kernel numbers
and, last, one JSON line with the device.  K5, K6 and K9, persistent
blocks that refill and compact their rays (csrc/persist.cuh), are held to
their plain versions bit for bit at the occupancy grid and at one block
(K9 on a reduced image), and their lane use is reported beside the one
that one thread per ray in static warps of 32 would have had on the same
rays; K9 also reports its sweep lane use (how many of the lanes sweeping
a chunk admitted it).  The reverse walks K8 and K7, persistent blocks of
reverse carries (csrc/walk_bwd.cuh), are held to their plain versions
within their bands at both grids, and their lane use is reported.  The
culled kernels K14 and K12/K13 walk a ray's chunks with a group of lanes
(csrc/trace.cuh group_walk); they are held bit for bit, counters
included, also on a pool batch cut to an odd lane count, and their group
lane use (slot tests over the slot-test lanes the groups issue) and
launch shape are printed.  Kernels shorter than their wrapper's host work
(K10-K14) are timed with the stream held while their launches are queued
(kernel_ms).  Then the distributed layer (parallel/): the ray-sharded
paths run every rank's shard in turn in one process (K5 at worlds 4 and 7,
the camera and walk training steps, the fused engine), render-dist runs
at world size 1 on NCCL, and the scene-sharded render runs as four gloo
processes on the card (this script with --scene-shard-worker); and a
scene file exported by the CLI renders the preset's image.  Last, the
modules that complete the port (phases 40-44): render_progressive's
shuffled fill on the mega engine at 1200x675 (50 chunks through K10 at a
pool of 2,048, three held against the plain bounce, the samples after it
against K5), the checkpoint cadence with a crash resumed bit for bit, the
JAX package's committed mega checkpoint resumed from 500 to 504 spp, the
CLI with --job, --fill shuffled and --snapshot-every on the auto engine,
the live display fetched over loopback, --sanitize, supervise restarting
a crashed and a hung render, and timed_best beside CUDA events.  Any
failed phase raises, so the exit code is nonzero and no result line is
printed.
Without a CUDA card it exits with code 2.

    python3 chip_smoke.py --record out/chip_smoke.json

also writes the run's numbers to that file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNELS = ("mega_render", "mega_forward", "mega_walk_bwd", "mega_walk", "mega_bwd",
           "fused_bounce", "intersect", "culled_intersect")
SOURCE = "distributed_raytracer_tpu_torch/csrc/{}.cu"
REPLACES = {
    "mega_render": "distributed_raytracer_tpu/ops/pallas/mega_render_kernel.py:179",
    "mega_forward": "distributed_raytracer_tpu/ops/pallas/mega_kernel.py:102",
    "mega_walk_bwd": "distributed_raytracer_tpu/ops/pallas/mega_walk_bwd_kernel.py:59",
    "mega_walk": "distributed_raytracer_tpu/ops/pallas/mega_walk_kernel.py:198",
    "mega_bwd": "distributed_raytracer_tpu/ops/pallas/mega_bwd_kernel.py:215",
    "fused_bounce": "distributed_raytracer_tpu/ops/pallas/bounce_kernel.py:306",
    "intersect": "distributed_raytracer_tpu/ops/pallas/intersect_kernel.py:50",
    "culled_intersect": "distributed_raytracer_tpu/ops/pallas/culled_kernel.py:136",
}
# rows whose source holds more than one TPU kernel: fused_bounce.cu is K10
# (dense) and K14 (the walk instantiation), culled_intersect.cu K12 (grid)
# and K13 (walk)
ROW_REPLACES = {
    "culled_closest_hit_walk": "distributed_raytracer_tpu/ops/pallas/culled_kernel.py:372",
    "culled_fused_bounce": "distributed_raytracer_tpu/ops/pallas/culled_bounce_kernel.py:136",
    "culled_fused_bounce_field":
        "distributed_raytracer_tpu/ops/pallas/culled_bounce_kernel.py:136",
}
# each row of the kernels line and the source it launches: K9 has two
# instantiations (render, pallas_call mega_walk_kernel.py:602; record,
# :734), K8 two shapes (the dense tracer's 512 spheres, whose bins all sit
# in shared memory; the walk's 8,448 slots, most of whose bins go to g_pm
# by global atomics), K6 two modes (camera; ray, mega_forward :512), and K8
# two instantiations (without and with ray grads); K14 two scenes (the
# final scene in 5 chunks of 128, the 8,192-sphere field in 65)
ROW_SOURCE = {"mega_forward": "mega_forward", "mega_walk_bwd": "mega_walk_bwd",
              "mega_walk": "mega_walk", "mega_walk_record": "mega_walk",
              "mega_walk_bwd_global": "mega_walk_bwd", "mega_forward_ray": "mega_forward",
              "mega_bwd": "mega_bwd", "mega_walk_bwd_rays": "mega_walk_bwd",
              "fused_bounce": "fused_bounce", "culled_fused_bounce": "fused_bounce",
              "culled_fused_bounce_field": "fused_bounce", "closest_hit": "intersect",
              "culled_closest_hit": "culled_intersect",
              "culled_closest_hit_walk": "culled_intersect"}
NO_LIBRARY = {  # why library_ms is null
    "mega_render": "no single PyTorch call computes a path-traced image sample",
    "mega_forward": "no single PyTorch call computes a recording path-traced sample",
    "mega_walk_bwd": "no single PyTorch call computes the reverse walk of a bounce tape",
    "mega_walk": "no single PyTorch call computes a path-traced sample with a chunk walk",
    "mega_bwd": "no single PyTorch call computes the reverse walk of a bounce tape",
    "fused_bounce": "no single PyTorch call computes a shaded bounce",
    "intersect": "no single PyTorch call computes a ray x sphere closest hit",
    "culled_intersect": "no single PyTorch call computes a culled ray x sphere closest hit",
}
FP32_LANES_PER_SM = 128      # Hopper SM: 4 partitions x 32 FP32 lanes
# FP32 operations of one ray x sphere test in the sweep (bounce.cuh
# sweep_winner): oc 3, h 5, c_q 6, disc 3, the compare 1; and the more a
# test whose discriminant is not negative does: sqrt, the two roots (2
# each), three compares
FLOPS_PER_TEST = 18
FLOPS_PER_NEAR_TEST = 8
# FP32 operations of one chunk bound test of the walk (trace.cuh
# chunk_admits): ob 3, h_b 5, c_b 6, disc_b 3, sqrt 1, near and far 2
# each, three compares
FLOPS_PER_BOUND_TEST = 25
WALK_CHUNK = 256             # slots per walk chunk, as render_progressive and bench.py use
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
# (the referee below), and the kernel's atomic order alone moves it 1e-6;
# also at the walk's main shape (1024x576 depth 8, 8,448 slots), where the
# two walks part by 1.09e-4 of an albedo column, also summed over terms of
# both signs, and the referee is printed as well
K8_MAIN_BAND = 1e-3
# the primary-ray cotangents of K7 and of K8 with ray grads against their
# plain versions, each component normalized by its max over the rays
# without a grazing hit (over all rays the grazing rays' large cotangents
# set the scale, and the band is K8_BAND or K8_MAIN_BAND as for g_pm): one
# ray's cotangent by forward-mode duals against reverse-mode autograd, no
# sums; measured 1.48e-4 (d_o z, 262,144 rays depth 8), where the float64
# referee puts the kernel 4.5e-4 and the plain walk 3.1e-4 from float64
RAY_CALM_BAND = 1e-3
# the ray-table tracer's shape (scripts/bench_megabwd.py:14-19): this many
# rays strided over the 1200x675 image, depth 50
RAY_TRACER_RAYS = 262144
# the fused engine's culled chunk (cli.py: --accel culled on the fused engine)
FUSED_CHUNK = 128
# the odd batch on which the group walks (K14, K12/K13) are also held: a
# pool batch's first lanes, one short of the pool, so the last block (and,
# at fewer than 32 lanes per ray, the last warp) is partial
ODD_LANES = 16383
# bytes of one lane of a fused bounce: o and d in (24), active (1) and the
# ray id (4); next o and d, attenuation, color and the unit draw out (60),
# finished, idx and u (12) and hit (1)
LANE_BYTES = 102
# clock cycles a second that kernel_ms's sleep counts at least (the H100
# SXM's SM clock is at most 1,980 MHz, so the sleep lasts no less than asked)
SLEEP_CYCLES_PER_S = 2.0e9
# launches replayed behind one sleep when a run's launches are replayed in
# groups (the shuffled fill's thousands of K10 launches)
FILL_REPLAY_GROUP = 256


class SmokeFailure(RuntimeError):
    pass


def require(cond, what) -> None:
    if not cond:
        raise SmokeFailure(str(what))


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_kernels(report: str) -> list:
    """Each kernel entry of one nvcc -Xptxas -v report: its name (with
    the bool template argument, if any), registers, spill stores and
    loads (bytes) and static shared memory (bytes)."""
    out = []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            name = m.group(2)[:int(m.group(1))]
            rest = m.group(2)[int(m.group(1)):]
            if rest.startswith("ILb"):
                name += "<true>" if rest.startswith("ILb1") else "<false>"
            out.append(dict(kernel=name, registers=None, spill_stores=0, spill_loads=0, smem=0))
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(m.group(1)) if m else 0
    return out


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


def kernel_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls on the card alone, by CUDA
    events, for kernels shorter than their wrapper's host work (argument
    checks, output allocations), which cuda_ms would time with the host's
    gaps between the launches: the calls run once untimed (a warm-up that
    also times the host's enqueue of reps calls), then a sleep kernel holds
    the stream for twice that while the calls are queued again between two
    events, so the card runs them back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * host_s + 1e-3) * SLEEP_CYCLES_PER_S))
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


def finished_static_lane_use(out) -> float:
    """The one-thread-per-ray reckoning for a reverse walk of this tape
    (the kernels before the persistent walk): static_lane_use of the
    lengths of the rays that finished, the others counted as no rows.  A
    ray's walk can end before its first row once its carry vanishes, so
    this uses the lengths as the rows walked."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk

    depth = (out.lengths.long() - 1).clamp(min=0)
    last = out.tape[depth, torch.arange(out.lengths.shape[0], device=out.tape.device)]
    fin = (last[:, mk.T_FLG].contiguous().view(torch.int32) & mk.F_FIN) != 0
    return mk.static_lane_use(torch.where(fin & (out.lengths > 0), out.lengths, 0))


def grazing_rays(out, ratio: float = 1e-3) -> torch.Tensor:
    """[R] bool: the rays with a grazing hit, a hit row whose discriminant
    disc = h*h - a*c is below ratio * h*h (float64, from the recorded row).
    There disc is the difference of two nearly equal numbers and the
    derivative of t carries 1 / sqrt(disc), so one f32 rounding moves a
    geometric gradient far (ROADMAP Queue 3)."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk

    graz = torch.zeros(out.lengths.shape[0], dtype=torch.bool, device=out.tape.device)
    for depth in range(out.tape.shape[0]):
        live = out.lengths > depth
        rows = out.tape[depth]
        hit = live & ((rows[:, mk.T_FLG].contiguous().view(torch.int32) & mk.F_HIT) != 0)
        t = rows[:, :mk.T_RW + 1].double()
        o, d, c = t[:, mk.T_O:mk.T_O + 3], t[:, mk.T_D:mk.T_D + 3], t[:, mk.T_CW:mk.T_CW + 3]
        oc = c - o
        h = (d * oc).sum(-1)
        disc = h * h - (d * d).sum(-1) * ((oc * oc).sum(-1) - t[:, mk.T_RW] ** 2)
        graz |= hit & (disc < ratio * h * h)
    return graz


def walk_lane(label, stats, one_stats) -> float:
    """The reverse walk's lane use from its WALK_STATS (rows, warp steps),
    printed with the one-block run's; the rows walked are the same at any
    grid (a ray's carry is not a sum)."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk

    rows, steps = (int(x) for x in stats.tolist())
    one_rows, one_steps = (int(x) for x in one_stats.tolist())
    lane = mk.lane_use(rows, steps)
    log(f"[lane] {label}: {rows:,} rows walked in {steps:,} warp steps, lane use {lane:.4f}; "
        f"one block {mk.lane_use(one_rows, one_steps):.4f}")
    require(rows == one_rows, f"{label}: rows walked differ with the grid ({rows} vs {one_rows})")
    require(0.0 < lane <= 1.0, f"{label}: lane use {lane} is not in (0, 1]")
    return lane


def k8_check(dev, label, out, n, band, referee=False):
    """K8 against its plain version on one tape, each column of g_pm
    normalized by its max (run twice at the occupancy grid, for the
    atomics' run-to-run spread, and once at one block); with referee,
    both against the same walk in float64.  Returns (max abs err, max
    normalized err, plain ms, g_color, lane use)."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk

    g = torch.randn(out.lengths.shape[0], 3,
                    generator=torch.Generator().manual_seed(3)).to(dev)
    got, stats = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n, with_stats=True)
    again = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n)
    one, one_stats = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n, grid=1,
                                                 with_stats=True)
    want, plain_ms = cuda_timed(lambda: wbk.mega_walk_backward_plain(out.tape, out.lengths,
                                                                     g, n))
    err = col_err(got[:n], want[:n])
    one_err = float(col_err(one[:n], want[:n]).max())
    fmt = lambda e: [f"{x:.2e}" for x in e.tolist()]
    log(f"[k8] {label}: per-column normalized err {fmt(err)}, run-to-run "
        f"{float(col_err(again[:n], got[:n]).max()):.2e} normalized "
        f"({float((got - again).abs().max()):.3e} abs), one block {one_err:.2e}, plain "
        f"{plain_ms:.1f} ms")
    lane = walk_lane(f"K8 {label}", stats, one_stats)
    if referee:  # both f32 walks against the same walk in float64
        exact = wbk.mega_walk_backward_plain(out.tape, out.lengths, g, n,
                                             dtype=torch.float64)[:n]
        log(f"[k8] {label}: vs the float64 walk, kernel {fmt(col_err(got[:n].double(), exact))}"
            f", plain {fmt(col_err(want[:n].double(), exact))}")
        # the same without the rays that have a grazing hit
        graz = grazing_rays(out)
        g_calm = torch.where(graz[:, None], 0.0, g)
        exact = wbk.mega_walk_backward_plain(out.tape, out.lengths, g_calm, n,
                                             dtype=torch.float64)[:n]
        k_calm = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g_calm, n)[:n]
        p_calm = wbk.mega_walk_backward_plain(out.tape, out.lengths, g_calm, n)[:n]
        log(f"[k8] {label}: {int(graz.sum()):,} of {graz.numel():,} rays have a grazing hit "
            f"(disc < 1e-3 h^2); without them, vs the float64 walk, kernel "
            f"{fmt(col_err(k_calm.double(), exact))}, plain {fmt(col_err(p_calm.double(), exact))}")
    require(bool(torch.isfinite(got).all() and torch.isfinite(one).all()),
            f"{label}: K8 gradients not finite")
    require(float(err.max()) < band, f"{label}: K8 vs plain {float(err.max()):.3e}")
    require(one_err < band, f"{label}: K8 at one block vs plain {one_err:.3e}")
    return float((got[:n] - want[:n]).abs().max()), float(err.max()), plain_ms, g, lane


def check_gradient_path(dev, presets, final, cam_main, k5_main, peak: float) -> dict:
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
    one = mk.mega_forward_camera_cuda(*args_main, grid=1, **kw_main)
    torch.cuda.synchronize()
    same_tape("final 1200x675 depth 50, one block", one, plain_main)
    del plain_main
    bounces, steps = int(out_main.bounces), int(out_main.warp_steps)
    require(bounces == int(out_main.lengths.sum()) == int(one.bounces),
            "K6's bounce count differs from its lengths")
    k6_lane = mk.lane_use(bounces, steps)
    k6_static = mk.static_lane_use(out_main.lengths)
    log(f"[lane] K6 camera final 1200x675 depth 50: {bounces:,} bounces in {steps:,} warp "
        f"steps, lane use {k6_lane:.4f}; one thread per ray in static warps of 32 consecutive "
        f"rays (the kernels before the persistent loop) {k6_static:.4f}; one block "
        f"{mk.lane_use(int(one.bounces), int(one.warp_steps)):.4f}")
    require(0.0 < k6_lane <= 1.0, f"K6 lane use {k6_lane} is not in (0, 1]")
    del one
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

    for label, scene, out in tapes:
        k8_check(dev, label, out, scene.num_spheres, K8_BAND)
    del tapes
    # the main-path shape: the numbers the kernel line reports
    k8_err, k8_norm_err, k8_plain_ms, g_main, k8_lane = k8_check(
        dev, "final 1200x675 depth 50", out_main, n_sph, K8_MAIN_BAND, referee=True)

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
    log(f"[time] K6 {k6_ms:.3f} ms (plain {k6_plain_ms:.1f} ms), K8 {k8_ms:.3f} ms (bound "
        f"{max(k8_bytes / HBM_BYTES_PER_S, k8_flops / peak) * 1e3:.4f} ms, lane "
        f"use {k8_lane:.4f}, plain {k8_plain_ms:.1f} ms) at the main path; tape "
        f"{out_main.tape.numel() * 4:,} B allocated, {rows * 128:,} B written ({rows:,} rows, {rows / n_pix:.4f} per ray); "
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
                             plain_ms=k6_plain_ms, flops=sweep["flops"], bytes=k6_bytes,
                             lane_use=k6_lane, lane_use_static=k6_static),
        "sweep": sweep,
        "mega_walk_bwd": dict(launches=launches["mega_walk_bwd"], max_abs_err=k8_err, ms=k8_ms,
                              plain_ms=k8_plain_ms, flops=k8_flops, bytes=k8_bytes,
                              max_norm_err=k8_norm_err, lane_use=k8_lane,
                              lane_use_static=finished_static_lane_use(out_main)),
        "record": dict(step_ms=step_ms, rays_per_s=n_pix / step_ms * 1e3, first_step_wall_ms=wall
                       * 1e3, adam_losses=losses, k6_lane_use=k6_lane,
                       k6_static_lane_use=k6_static, tape_bytes_allocated=out_main.tape.numel() * 4,
                       tape_bytes_written=rows * 128, tape_rows=rows, k8_rows=k8_rows,
                       sweep=sweep, k8_max_norm_err=k8_norm_err, k8_lane_use=k8_lane),
    }


def walk_camera(presets, width: int):
    """bench.py:317-322's walk camera (16:9, depth 8) at a given width."""
    return presets.make_camera(aspect_ratio=16.0 / 9.0, image_width=width, samples_per_pixel=4,
                               max_depth=8, vfov=55.0, lookfrom=(0.0, 20.0, 60.0),
                               lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0), defocus_angle=0.0,
                               focus_dist=10.0)


def k9_cost(stats, pack, n_rays: int, tape_rows: int = 0) -> dict:
    """The FP32 operations and bytes a walk run with these counters needs:
    one bound test per bounce and finite-bound chunk, and the admitted
    chunks' slot tests at K5's counts; the pack read once, the colors (and
    the tape rows and lengths) written once."""
    bounces, admitted, tests, near = (int(x) for x in stats.tolist())
    finite = int(torch.isfinite(pack.bounds[:pack.n_chunks, 3]).sum())
    flops = (bounces * finite * FLOPS_PER_BOUND_TEST + tests * FLOPS_PER_TEST
             + near * FLOPS_PER_NEAR_TEST)
    nbytes = (pack.n_slots * (4 + 11) * 4 + pack.bounds.numel() * 4 + pack.n_chunks * 4
              + 24 * 4 + n_rays * 12 + 32)
    if tape_rows:
        nbytes += tape_rows * 128 + n_rays * 4
    live = int((pack.slot_to_orig >= 0).sum())
    return dict(bounces=bounces, admitted=admitted, tests=tests, near=near,
                finite_chunks=finite, live=live, dense_tests=bounces * live, flops=flops,
                bytes=nbytes)


def k9_lanes(label, stats, warp_stats, lengths=None) -> dict:
    """K9's lane use (bounces over 32 x warp steps) and sweep lane use
    (slot tests of admitted chunks over 32 x the slot-test rounds the warps
    issued) from one launch's counters; with lengths, also the lane use
    one thread per ray in static warps of 32 consecutive rays had (K9
    before the persistent loop)."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk

    bounces, tests = int(stats[0]), int(stats[2])
    steps, warp_tests = (int(x) for x in warp_stats.tolist())
    out = dict(lane_use=mk.lane_use(bounces, steps),
               sweep_lane_use=mk.sweep_lane_use(tests, warp_tests))
    before = ""
    if lengths is not None:
        out["lane_use_static"] = mk.static_lane_use(lengths)
        before = f"; one thread per ray in static warps of 32 {out['lane_use_static']:.4f}"
    log(f"[lane] K9 {label}: {bounces:,} bounces in {steps:,} warp steps, lane use "
        f"{out['lane_use']:.4f}; {tests:,} slot tests of admitted chunks in {warp_tests:,} "
        f"warp slot tests, sweep lane use {out['sweep_lane_use']:.4f}{before}")
    require(0.0 < out["lane_use"] <= 1.0 and 0.0 < out["sweep_lane_use"] <= 1.0,
            f"K9 {label}: lane use out of (0, 1]: {out}")
    return out


def check_record(label, rec, rec_plain, render_colors, plain_ms) -> float:
    """K9 record against its plain version: lengths, written tape rows,
    colors and counters bit for bit, and its colors equal to K9 render's.
    Returns the max abs error over the rows' float columns and the colors."""
    gr, wr = written_rows(rec), written_rows(rec_plain)
    require(torch.equal(rec.lengths, rec_plain.lengths), "K9 record lengths differ from plain")
    err = max(float((gr[:, :26] - wr[:, :26]).abs().max()),
              float((rec.colors - rec_plain.colors).abs().max()))
    same = (torch.equal(gr.view(torch.int32), wr.view(torch.int32))
            and torch.equal(rec.colors, rec_plain.colors))
    log(f"[k9] record {label}: {gr.shape[0]:,} tape rows, max abs err {err:.3e}, rows and "
        f"colors equal bit for bit {same}; record colors == render colors "
        f"{torch.equal(rec.colors, render_colors)}; stats kernel {rec.stats.tolist()} plain "
        f"{rec_plain.stats.tolist()}; plain {plain_ms:.1f} ms")
    require(same, "K9 record differs from its plain version")
    require(torch.equal(rec.stats.cpu(), rec_plain.stats.cpu()),
            "K9 record counters differ from the plain count")
    require(torch.equal(rec.colors, render_colors), "K9 record colors differ from K9 render's")
    return err


def check_walk_path(dev, presets, final, cam_main, k5_main, k5_bounces, k5_ms,
                    peak: float) -> dict:
    """Phases 10-14: the walk engine past 512 spheres.  K9 against K5 on
    the main path's scene; on the 8,192-sphere field, K9 render and record
    against their plain versions and K8 past 512 slots against the plain
    walk, at a reduced image (with the float64 referee) and at the bench's
    shape; the walk training step at the bench's shape, and
    render_progressive routed to the walk."""
    from distributed_raytracer_tpu_torch import image_loss, make_tape_camera_walk_tracer
    from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
    from distributed_raytracer_tpu_torch.render.progressive import (
        batch_seeds,
        render_progressive,
    )

    def args_of(pack, cam):
        p = pack.to(dev)
        return (p.scene_pack, p.attrs, p.bounds, p.chunk_len,
                camera_scalar_row(cam).to(dev).contiguous())

    def sample_kw(cam, sample=0, bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED):
        n = cam.num_pixels
        return dict(bounce_seed=bounce_seed, cam_seed=cam_seed, rid_base=sample * n, pix0=0,
                    n_valid=n, n_cap=n, w=cam.image_width, max_depth=cam.max_depth)

    def per_ray(st, n):
        return (f"{st['bounces'] / n:.4f} bounces, {st['admitted'] / n:.3f} chunks admitted, "
                f"{st['tests'] / n:,.1f} slot tests ({st['dense_tests'] / n:,.1f} dense, "
                f"{st['tests'] / max(st['dense_tests'], 1):.2%}), {st['near'] / n:.3f} with "
                f"disc >= 0 per ray")

    # --- phase 10: K9 against K5 on the main path (final 1200x675 depth 50) ---
    pack_f = mwk.walk_pack_for(final, cam_main, chunk=WALK_CHUNK)
    args_f, kw_f = args_of(pack_f, cam_main), sample_kw(cam_main)
    k9_f, st_f, warp_f = mwk.mega_walk_sample_cuda(*args_f, with_warp_stats=True, **kw_f)
    torch.cuda.synchronize()
    err = float((k9_f - k5_main).abs().max())
    log(f"[k9] final 1200x675 depth 50 through walk_pack_for(chunk={WALK_CHUNK}): "
        f"{pack_f.n_chunks} chunks, chunk_len {pack_f.chunk_len.tolist()}; K9 vs K5 max abs err "
        f"{err:.3e}, bounces {int(st_f[0])} vs {k5_bounces}")
    require(torch.equal(k9_f, k5_main), "K9 colors differ from K5's at the main path")
    require(int(st_f[0]) == k5_bounces, "K9 and K5 bounce counts differ")
    k9_f_ms = cuda_ms(lambda: mwk.mega_walk_sample_cuda(*args_f, **kw_f), 5)
    cost_f = k9_cost(st_f, pack_f, cam_main.num_pixels)
    log(f"[time] final 1200x675 depth 50: K9 {k9_f_ms:.3f} ms vs K5 {k5_ms:.3f} ms per sample; "
        + per_ray(cost_f, cam_main.num_pixels))
    lanes_f = k9_lanes("render, final 1200x675 depth 50", st_f, warp_f)

    # --- phase 11: K9 render and record against their plain versions, at the
    # occupancy grid and at one block (reduced image, which one block traces in well
    # under a second and whose tape phase 12's float64 referee can afford) ---
    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    cam_big, cam_small = walk_camera(presets, 1024), walk_camera(presets, 256)
    pack = mwk.walk_pack_for(field, cam_big, chunk=WALK_CHUNK)
    log(f"[k9] field of {field.num_spheres} spheres: {pack.n_chunks} chunks of {WALK_CHUNK}, "
        f"{pack.n_slots} slots, {int(torch.isinf(pack.bounds[:pack.n_chunks, 3]).sum())} "
        f"always swept")
    args_s, kw_s = args_of(pack, cam_small), sample_kw(cam_small)
    n_s = cam_small.num_pixels
    (want, want_st), plain_ms = cuda_timed(lambda: mwk.mega_walk_sample_plain(*args_s, **kw_s))
    small = f"{cam_small.image_width}x{cam_small.image_height} depth 8"
    fkw = dict(bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED, pix0=0, n_valid=n_s,
               w=cam_small.image_width, max_depth=cam_small.max_depth)
    rec_plain, rec_plain_ms = cuda_timed(
        lambda: mwk.mega_walk_forward_camera_plain(*args_s, **fkw))
    for grid, at in ((None, ""), (1, ", one block")):
        got, got_st, warp = mwk.mega_walk_sample_cuda(*args_s, grid=grid, with_warp_stats=True,
                                                      **kw_s)
        torch.cuda.synchronize()
        log(f"[k9] render {small}{at}: max abs err {float((got - want).abs().max()):.3e}, "
            f"equal bit for bit {torch.equal(got, want)}; stats kernel {got_st.tolist()} plain "
            f"{want_st.tolist()} ({', '.join(mwk.STATS)}); plain {plain_ms:.1f} ms")
        require(torch.equal(got, want), f"K9 render{at} differs from its plain version")
        require(torch.equal(got_st.cpu(), want_st.cpu()),
                f"K9{at} counters differ from the plain count")
        k9_lanes(f"render, field {small}{at}", got_st, warp)
        rec = mwk.mega_walk_forward_camera_cuda(*args_s, grid=grid, **fkw)
        check_record(small + at, rec, rec_plain, got, rec_plain_ms)
        require(torch.equal(rec.stats, got_st), "K9 record and render counters differ")
        k9_lanes(f"record, field {small}{at}", rec.stats, rec.warp_stats)

    # --- phase 12: K8 past 512 slots against the plain walk on that tape (the
    # one-block record's, equal to the grid's) ---
    k8_check(
        dev, f"walk tape, {pack.n_slots} slots, {cam_small.image_width}x"
        f"{cam_small.image_height} depth 8", rec, pack.n_slots, K8_BAND, referee=True)
    del rec_plain, want, rec

    # --- phase 13: the walk training step at the bench's shape, through the entry points ---
    # the field padded with spheres of radius 0, which the pack leaves out
    field_p = presets.random_sphere_field(8192, seed=5, extent=30.0, pad_to=8200)
    tracer = make_tape_camera_walk_tracer(cam_big, BOUNCE_SEED, CAM_SEED, field_p,
                                          chunk=WALK_CHUNK)
    n_big = cam_big.num_pixels
    ids = torch.arange(n_big)
    target = torch.zeros(n_big, 3, device=dev)
    p = {k: v.to(dev).clone().requires_grad_() for k, v in field_p.diff_params().items()}
    scene_p = field_p.with_diff_params(p)
    mwk.mega_walk_forward_camera_cuda.launches = 0
    wbk.mega_walk_backward_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    colors = tracer(scene_p, ids)
    loss = image_loss(colors, target)
    loss.backward()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"mega_walk_record": mwk.mega_walk_forward_camera_cuda.launches,
                "mega_walk_bwd": wbk.mega_walk_backward_cuda.launches}
    log(f"[walk-train] field {field_p.num_spheres} entries ({field.num_spheres} spheres) "
        f"{cam_big.image_width}x{cam_big.image_height} depth 8, {n_big:,} rays: loss "
        f"{loss.item():.6f}, first step {wall * 1e3:.1f} ms wall, launches {launches}")
    require(launches == {"mega_walk_record": 1, "mega_walk_bwd": 1},
            f"the walk training step did not launch K9 and K8 once each: {launches}")
    absent = field_p.radii.to(dev) <= 0
    for k, v in p.items():
        require(bool(torch.isfinite(v.grad).all()), f"walk {k} gradient not finite")
        require(float(v.grad[absent].abs().max()) == 0.0, f"walk {k} gradient nonzero on an "
                "absent sphere")
    for k in ("centers", "albedo"):
        require(float(p[k].grad[~absent].abs().max()) > 0.0, f"walk {k} gradient is zero")
    log(f"[walk-train] grads finite; absent spheres ({int(absent.sum())}) zero; max |grad| "
        + ", ".join(f"{k} {float(v.grad.abs().max()):.3e}" for k, v in p.items()))
    args_b, kw_b = args_of(pack, cam_big), sample_kw(cam_big)
    ren_b, _ = mwk.mega_walk_sample_cuda(*args_b, **kw_b)
    torch.cuda.synchronize()
    require(torch.equal(colors.detach(), ren_b), "walk tracer colors differ from the walk render")

    def step():
        for v in p.values():
            v.grad = None
        image_loss(tracer(scene_p, ids), target).backward()

    step_ms = cuda_ms(step, 3)
    log(f"[time] walk fwd+bwd step {step_ms:.3f} ms ({n_big / step_ms * 1e3:,.0f} rays/s)")
    # K9 record and K8 at the step's shape against their plain versions
    fkw_b = dict(bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED, pix0=0, n_valid=n_big,
                 w=cam_big.image_width, max_depth=cam_big.max_depth)
    rec_b = mwk.mega_walk_forward_camera_cuda(*args_b, **fkw_b)
    rec_bp, record_plain_ms = cuda_timed(
        lambda: mwk.mega_walk_forward_camera_plain(*args_b, **fkw_b))
    record_err = check_record(f"{cam_big.image_width}x{cam_big.image_height} depth 8", rec_b,
                              rec_bp, ren_b, record_plain_ms)
    del rec_bp
    record_ms = cuda_ms(lambda: mwk.mega_walk_forward_camera_cuda(*args_b, **fkw_b), 3)
    lanes_rec = k9_lanes(f"record, field {cam_big.image_width}x{cam_big.image_height} depth 8",
                         rec_b.stats, rec_b.warp_stats, rec_b.lengths)
    k8w_err, k8w_norm, k8w_plain_ms, g_b, k8w_lane = k8_check(
        dev, f"walk tape, {pack.n_slots} slots, {cam_big.image_width}x{cam_big.image_height} "
        "depth 8", rec_b, pack.n_slots, K8_MAIN_BAND, referee=True)
    k8w_ms = cuda_ms(lambda: wbk.mega_walk_backward_cuda(rec_b.tape, rec_b.lengths, g_b,
                                                         pack.n_slots), 3)
    rows_b = int(rec_b.lengths.sum())
    cost_rec = k9_cost(rec_b.stats, pack, n_big, tape_rows=rows_b)
    k8w_flops, k8w_bytes, k8w_rows = walk_work(rec_b, pack.n_slots)
    log(f"[time] walk step parts: K9 record {record_ms:.3f} ms (bound "
        f"{cost_rec['flops'] / peak * 1e3:.4f} ms, lane use {lanes_rec['lane_use']:.4f}, sweep "
        f"lane use {lanes_rec['sweep_lane_use']:.4f}), K8 ({pack.n_slots} slots) {k8w_ms:.3f} "
        f"ms (lane use {k8w_lane:.4f}); tape {rows_b:,} rows ({rows_b / n_big:.4f} per ray), "
        f"K8 reads {k8w_rows:,}; " + per_ray(cost_rec, n_big))

    # --- phase 14: render_progressive routes the field to the walk (K9) ---
    mwk.mega_walk_sample_cuda.launches = 0
    mrk.mega_render_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    state = render_progressive(field, cam_big, seed=0, spp=4, batch=4, engine="mega")
    torch.cuda.synchronize()
    wall = time.time() - t0
    walk_launches = mwk.mega_walk_sample_cuda.launches
    log(f"[walk-main] render_progressive field {cam_big.image_width}x{cam_big.image_height} "
        f"depth 8 spp 4: {wall * 1e3 / 4:.2f} ms/sample wall, launches K9 {walk_launches}, "
        f"K5 {mrk.mega_render_cuda.launches}")
    require(walk_launches == 4 and mrk.mega_render_cuda.launches == 0,
            "render_progressive past 512 spheres did not route to the walk")
    want_sum = mwk.render_wavefront_sum_mega_walk(pack, cam_big, 4, *batch_seeds(0, 0),
                                                  device=dev)
    require(np.array_equal(state.raw_sum, want_sum.cpu().numpy()),
            "render_progressive differs from render_wavefront_sum_mega_walk")
    img = state.mean_image()
    require(np.isfinite(img).all() and img.shape == (cam_big.image_height, cam_big.image_width, 3),
            "walk image is not finite")
    log("[walk-main] equals render_wavefront_sum_mega_walk bit for bit; top-center pixel "
        f"{img[0, cam_big.image_width // 2].tolist()}")
    kw_e = sample_kw(cam_big, bounce_seed=batch_seeds(0, 0)[0], cam_seed=batch_seeds(0, 0)[1])
    got_e, st_e, warp_e = mwk.mega_walk_sample_cuda(*args_b, with_warp_stats=True, **kw_e)
    (want_e, want_st_e), render_plain_ms = cuda_timed(
        lambda: mwk.mega_walk_sample_plain(*args_b, **kw_e))
    render_err = float((got_e - want_e).abs().max())
    log(f"[k9] render {cam_big.image_width}x{cam_big.image_height} depth 8: max abs err "
        f"{render_err:.3e}, equal bit for bit {torch.equal(got_e, want_e)}; stats kernel "
        f"{st_e.tolist()} plain {want_st_e.tolist()}; plain {render_plain_ms:.1f} ms")
    require(torch.equal(got_e, want_e), "K9 render differs from its plain version")
    require(torch.equal(st_e.cpu(), want_st_e.cpu()), "K9 counters differ from the plain count")
    del want_e
    render_ms = cuda_ms(lambda: mwk.mega_walk_sample_cuda(*args_b, **kw_e), 5)
    cost_ren = k9_cost(st_e, pack, n_big)
    lanes_ren = k9_lanes(f"render, field {cam_big.image_width}x{cam_big.image_height} depth 8",
                         st_e, warp_e)
    log(f"[time] walk render {render_ms:.3f} ms per sample ({n_big / render_ms * 1e3:,.0f} "
        f"rays/s), bound {cost_ren['flops'] / peak * 1e3:.4f} ms ({cost_ren['flops']:,} FP32 "
        f"operations), lane use {lanes_ren['lane_use']:.4f}, sweep lane use "
        f"{lanes_ren['sweep_lane_use']:.4f}; " + per_ray(cost_ren, n_big))

    return {
        "mega_walk": dict(launches=walk_launches, max_abs_err=render_err, ms=render_ms,
                          plain_ms=render_plain_ms, flops=cost_ren["flops"],
                          bytes=cost_ren["bytes"], **lanes_ren),
        "mega_walk_record": dict(launches=launches["mega_walk_record"], max_abs_err=record_err,
                                 ms=record_ms, plain_ms=record_plain_ms,
                                 flops=cost_rec["flops"], bytes=cost_rec["bytes"], **lanes_rec),
        "mega_walk_bwd_global": dict(launches=launches["mega_walk_bwd"], max_abs_err=k8w_err,
                                     ms=k8w_ms, plain_ms=k8w_plain_ms, flops=k8w_flops,
                                     bytes=k8w_bytes, max_norm_err=k8w_norm, lane_use=k8w_lane,
                                     lane_use_static=finished_static_lane_use(rec_b)),
        "record": dict(k9_final_ms=k9_f_ms, k5_final_ms=k5_ms, final_cost=cost_f,
                       render_cost=cost_ren, record_cost=cost_rec, step_ms=step_ms,
                       rays_per_s=n_big / step_ms * 1e3, k8_walk_ms=k8w_ms,
                       k8_walk_norm_err=k8w_norm, progressive_ms_per_sample=wall * 1e3 / 4,
                       tape_rows=rows_b, k8_rows=k8w_rows, k9_final_lanes=lanes_f,
                       k9_render_lanes=lanes_ren, k9_record_lanes=lanes_rec,
                       k8_walk_lane_use=k8w_lane),
    }


def ray_walk_check(label, out, n, kernel, plain, band, referee=False):
    """A reverse walk with ray grads (K7, or K8 with ray_grads) against its
    plain version on one tape: g_pm's nine columns and the ray cotangents'
    six components, each normalized by its max, the kernel run twice (the
    atomics' run-to-run spread; the ray cotangents have no atomics), and
    once at one block.  kernel(g, **kw) (kw: the wrapper's grid= and
    with_stats=) and plain(g, dtype) return (g_pm, g_ray).  g_pm and the ray
    cotangents are held to band over all rays, the ray cotangents also to
    RAY_CALM_BAND normalized over the rays without a grazing hit (where
    1 / sqrt(disc) enters d_o and d_d directly).  With referee, both against the
    same walk in float64, with and without the grazing rays.  Returns (max
    abs err, max normalized err, plain ms, g_color, the kernel's result,
    lane use)."""
    dev = out.tape.device
    g = torch.randn(out.lengths.shape[0], 3,
                    generator=torch.Generator().manual_seed(3)).to(dev)
    *got, stats = kernel(g, with_stats=True)
    again = kernel(g)
    *one, one_stats = kernel(g, grid=1, with_stats=True)
    want, plain_ms = cuda_timed(lambda: plain(g, torch.float32))
    graz = grazing_rays(out)

    def errs(a, b, rays=slice(None)):
        return torch.cat([col_err(a[0][:n].double(), b[0][:n].double()),
                          col_err(a[1][rays].double(), b[1][rays].double())])

    fmt = lambda e: [f"{x:.2e}" for x in e.tolist()]
    err, calm = errs(got, want), errs(got, want, ~graz)
    log(f"[walk] {label}: vs plain, g_pm {fmt(err[:9])}; ray cotangents {fmt(err[9:])} all "
        f"rays, {fmt(calm[9:])} without the {int(graz.sum()):,} of {graz.numel():,} with a "
        f"grazing hit; run-to-run {float(errs(again, got).max()):.2e} normalized, ray "
        f"cotangents equal {torch.equal(again[1], got[1])}; one block vs plain "
        f"{float(errs(one, want).max()):.2e}, ray cotangents equal the grid's "
        f"{torch.equal(one[1], got[1])}; plain {plain_ms:.1f} ms")
    lane = walk_lane(label, stats, one_stats)
    require(torch.equal(one[1], got[1]), f"{label}: ray cotangents differ with the grid")
    if referee:  # both f32 walks against the same walk in float64
        exact = plain(g, torch.float64)
        log(f"[walk] {label}: vs the float64 walk, kernel {fmt(errs(got, exact))}, plain "
            f"{fmt(errs(want, exact))}")
        g_calm = torch.where(graz[:, None], 0.0, g)
        exact, k_calm, p_calm = (plain(g_calm, torch.float64), kernel(g_calm),
                                 plain(g_calm, torch.float32))
        log(f"[walk] {label}: without the grazing rays, vs the float64 walk, kernel "
            f"{fmt(errs(k_calm, exact))}, plain {fmt(errs(p_calm, exact))}")
    for at, res in (("", got), (" at one block", one)):
        err, calm = errs(res, want), errs(res, want, ~graz)
        require(bool(torch.isfinite(res[0]).all() and torch.isfinite(res[1]).all()),
                f"{label}{at}: gradients not finite")
        require(float(err.max()) < band, f"{label}{at}: vs plain {float(err.max()):.3e}")
        require(float(calm[9:].max()) < RAY_CALM_BAND,
                f"{label}{at}: ray cotangents without the grazing rays vs plain "
                f"{float(calm[9:].max()):.3e}")
    err = errs(got, want)
    abs_err = max(float((got[0][:n] - want[0][:n]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
    return abs_err, float(err.max()), plain_ms, g, got, lane


def check_ray_pose_path(dev, final, cam_main) -> dict:
    """Phases 15-18: gradients through rays and the camera pose.  K6 in ray
    mode against its plain version and against K6 in camera mode; K7
    against its plain version and against K8 on one tape; K8 with ray grads
    against its plain version; then the ray-table tracer and the pose
    tracer at full width through the entry points."""
    from distributed_raytracer_tpu_torch import (
        image_loss,
        make_tape_camera_pose_tracer,
        make_tape_tracer,
    )
    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row
    from distributed_raytracer_tpu_torch.ops.kernels import mega_bwd_kernel as mbk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk

    cols, attrs, cam_row = mrk.prepare(final, cam_main, dev)
    n_sph, n_pix, w = final.num_spheres, cam_main.num_pixels, cam_main.image_width

    def rays_of(pix):
        return mrk.camera_rays_host(cam_row, pix, pix, CAM_SEED, w)

    def ray_fwd(o, d, depth):
        return mk.mega_forward_cuda(cols, attrs, o, d, bounce_seed=BOUNCE_SEED, max_depth=depth)

    def same_tape(label, got, want):
        """The two recording forwards wrote the same lengths, rows and
        colors, bit for bit; returns the max abs difference of the float
        columns and the colors."""
        require(torch.equal(got.lengths, want.lengths), f"{label}: K6 lengths differ")
        gr, wr = written_rows(got), written_rows(want)
        err = max(float((gr[:, :mk.T_IDX] - wr[:, :mk.T_IDX]).abs().max()),
                  float((got.colors - want.colors).abs().max()))
        same = (torch.equal(gr.view(torch.int32), wr.view(torch.int32))
                and torch.equal(got.colors, want.colors))
        log(f"[k6-ray] {label}: tape rows {gr.shape[0]:,}, max abs err {err:.3e}, rows and "
            f"colors equal bit for bit {same}")
        require(same, f"{label}: K6 ray mode differs")
        return err

    # --- phase 15: K6 ray mode against its plain version and against camera mode ---
    ids = torch.arange(RAY_TRACER_RAYS, dtype=torch.int64, device=dev) * n_pix // RAY_TRACER_RAYS
    o_s, d_s = rays_of(ids)
    for depth in (8, cam_main.max_depth):  # reduced, then the ray tracer's shape
        got = ray_fwd(o_s, d_s, depth)
        want, ray_plain_ms = cuda_timed(lambda: mk.mega_forward_plain(
            cols, attrs, o_s, d_s, bounce_seed=BOUNCE_SEED, max_depth=depth))
        ray_err = same_tape(f"final, {RAY_TRACER_RAYS:,} strided rays, depth {depth}, vs plain "
                            f"({ray_plain_ms:.1f} ms)", got, want)
        one = mk.mega_forward_cuda(cols, attrs, o_s, d_s, bounce_seed=BOUNCE_SEED,
                                   max_depth=depth, grid=1)
        same_tape(f"final, {RAY_TRACER_RAYS:,} strided rays, depth {depth}, one block vs plain",
                  one, want)
        del one
    out_ray = got
    del want
    bounces, steps = int(out_ray.bounces), int(out_ray.warp_steps)
    require(bounces == int(out_ray.lengths.sum()), "K6 ray mode's bounce count differs")
    ray_lane, ray_static = mk.lane_use(bounces, steps), mk.static_lane_use(out_ray.lengths)
    log(f"[lane] K6 ray mode, {RAY_TRACER_RAYS:,} strided rays depth 50: {bounces:,} bounces in "
        f"{steps:,} warp steps, lane use {ray_lane:.4f}; static warps of 32 {ray_static:.4f}")
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)
    o_m, d_m = rays_of(pix)
    cam_kw = dict(bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED, pix0=0, n_valid=n_pix, w=w,
                  max_depth=cam_main.max_depth)
    out_main = mk.mega_forward_camera_cuda(cols, attrs, cam_row, None, **cam_kw)
    same_tape("final 1200x675 depth 50, rays of camera_rays_host vs camera mode",
              ray_fwd(o_m, d_m, cam_main.max_depth), out_main)
    del o_m, d_m
    ray_ms = cuda_ms(lambda: ray_fwd(o_s, d_s, cam_main.max_depth), 3)
    sweep = sweep_work(out_ray, cols)
    rows_ray = int(out_ray.lengths.sum())
    ray_bytes = rows_ray * 128 + RAY_TRACER_RAYS * (24 + 16) + 15 * n_sph * 4 + 8

    # --- phase 16: K7 against its plain version, and against K8 on one tape ---
    def k7(out):
        return (lambda g, **kw: mbk.mega_backward_cuda(cols, attrs, out.tape, out.lengths, g,
                                                       n_sph, **kw),
                lambda g, dt: mbk.mega_backward_plain(cols, attrs, out.tape, out.lengths, g,
                                                      n_sph, dtype=dt))

    out_8 = ray_fwd(o_s, d_s, 8)
    ray_walk_check(f"K7, {RAY_TRACER_RAYS:,} rays depth 8", out_8, n_sph, *k7(out_8), K8_BAND,
                   referee=True)
    del out_8
    k7_err, k7_norm, k7_plain_ms, g_ray_tr, k7_got, k7_lane = ray_walk_check(
        f"K7, {RAY_TRACER_RAYS:,} rays depth 50", out_ray, n_sph, *k7(out_ray), K8_MAIN_BAND,
        referee=True)
    k8_on = wbk.mega_walk_backward_cuda(out_ray.tape, out_ray.lengths, g_ray_tr, n_sph,
                                        ray_grads=True)
    torch.cuda.synchronize()
    k78 = float(col_err(k7_got[0][:n_sph], k8_on[0][:n_sph]).max())
    k78_rays = torch.equal(k7_got[1], k8_on[1])
    log(f"[k7] K7 vs K8 with ray grads on one tape: g_pm {k78:.2e} normalized (atomics' order), "
        f"ray cotangents equal bit for bit {k78_rays}")
    require(k78 < K8_BAND and k78_rays, "K7 and K8 differ on one tape")
    k7_ms = cuda_ms(lambda: mbk.mega_backward_cuda(cols, attrs, out_ray.tape, out_ray.lengths,
                                                   g_ray_tr, n_sph), 3)
    k7_flops, k7_bytes, k7_rows = walk_work(out_ray, n_sph)
    k7_static = finished_static_lane_use(out_ray)
    k7_bytes += RAY_TRACER_RAYS * 24 + 15 * n_sph * 4

    # --- phase 17: K8 with ray grads against its plain version ---
    def k8r(out):
        return (lambda g, **kw: wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n_sph,
                                                            ray_grads=True, **kw),
                lambda g, dt: wbk.mega_walk_backward_plain(out.tape, out.lengths, g, n_sph,
                                                           dtype=dt, ray_grads=True))

    out_c8 = mk.mega_forward_camera_cuda(cols, attrs, cam_row, None,
                                         **dict(cam_kw, max_depth=8))
    _, _, _, g8, got8, _ = ray_walk_check("K8 with ray grads, final 1200x675 depth 8", out_c8,
                                       n_sph, *k8r(out_c8), K8_BAND)
    off = wbk.mega_walk_backward_cuda(out_c8.tape, out_c8.lengths, g8, n_sph)
    off_err = float(col_err(off[:n_sph], got8[0][:n_sph]).max())
    log(f"[k8] without ray grads vs with, same tape: g_pm {off_err:.2e} normalized "
        f"(atomics' order)")
    require(off_err < K8_BAND, "K8 with and without ray grads differ")
    del out_c8
    k8r_err, k8r_norm, k8r_plain_ms, g_main, _, k8r_lane = ray_walk_check(
        "K8 with ray grads, final 1200x675 depth 50", out_main, n_sph, *k8r(out_main),
        K8_MAIN_BAND, referee=True)
    k8r_ms = cuda_ms(lambda: wbk.mega_walk_backward_cuda(out_main.tape, out_main.lengths, g_main,
                                                         n_sph, ray_grads=True), 3)
    k8_off_ms = cuda_ms(lambda: wbk.mega_walk_backward_cuda(out_main.tape, out_main.lengths,
                                                            g_main, n_sph), 3)
    k6_cam_ms = cuda_ms(lambda: mk.mega_forward_camera_cuda(cols, attrs, cam_row, None,
                                                            **cam_kw), 3)
    k8r_flops, k8r_bytes, _ = walk_work(out_main, n_sph)
    k8r_bytes += n_pix * 24
    k8r_static = finished_static_lane_use(out_main)
    del out_main

    # --- phase 18: both tracers at full width, through the entry points ---
    p = {k: v.to(dev).clone().requires_grad_() for k, v in final.diff_params().items()}
    scene_p = final.with_diff_params(p)
    ray_o, ray_d = o_s.clone().requires_grad_(), d_s.clone().requires_grad_()
    tracer = make_tape_tracer(prng.PRNGKey(1), cam_main.max_depth, use_mega=True, mega_bwd=True)
    target = torch.zeros(RAY_TRACER_RAYS, 3, device=dev)
    mk.mega_forward_cuda.launches = 0
    mbk.mega_backward_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    loss = image_loss(tracer(scene_p, ray_o, ray_d), target)
    loss.backward()
    torch.cuda.synchronize()
    wall = time.time() - t0
    ray_launches = {"mega_forward_ray": mk.mega_forward_cuda.launches,
                    "mega_bwd": mbk.mega_backward_cuda.launches}
    log(f"[ray-train] final, {RAY_TRACER_RAYS:,} strided rays depth 50: loss {loss.item():.6f}, "
        f"first step {wall * 1e3:.1f} ms wall, launches {ray_launches}")
    require(all(v >= 1 for v in ray_launches.values()),
            f"the ray-table step skipped a kernel: {ray_launches}")
    for name, t in [*p.items(), ("ray_o", ray_o), ("ray_d", ray_d)]:
        require(bool(torch.isfinite(t.grad).all()), f"ray-table {name} gradient not finite")
    require(float(ray_d.grad.abs().max()) > 0.0 and float(p["albedo"].grad.abs().max()) > 0.0,
            "ray-table gradients are zero")
    log("[ray-train] grads finite; max |grad| " + ", ".join(
        f"{k} {float(t.grad.abs().max()):.3e}" for k, t in [*p.items(), ("ray_o", ray_o),
                                                            ("ray_d", ray_d)]))

    def ray_step():
        for t in (*p.values(), ray_o, ray_d):
            t.grad = None
        image_loss(tracer(scene_p, ray_o, ray_d), target).backward()

    ray_step_ms = cuda_ms(ray_step, 3)
    log(f"[time] ray-table fwd+bwd step {ray_step_ms:.3f} ms "
        f"({RAY_TRACER_RAYS / ray_step_ms * 1e3:,.0f} rays/s): K6 ray {ray_ms:.3f} ms "
        f"({ray_ms / ray_step_ms:.1%}), K7 {k7_ms:.3f} ms ({k7_ms / ray_step_ms:.1%}, lane use "
        f"{k7_lane:.4f}), the rest "
        f"{ray_step_ms - ray_ms - k7_ms:.3f} ms; tape {rows_ray:,} rows, K7 reads {k7_rows:,}")

    pose = make_tape_camera_pose_tracer(cam_main, BOUNCE_SEED, CAM_SEED)
    row = camera_scalar_row(cam_main).to(dev).requires_grad_()
    target = torch.zeros(n_pix, 3, device=dev)
    for v in p.values():
        v.grad = None
    mk.mega_forward_camera_cuda.launches = 0
    wbk.mega_walk_backward_cuda.ray_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    loss = image_loss(pose(scene_p, row), target)
    loss.backward()
    torch.cuda.synchronize()
    wall = time.time() - t0
    pose_launches = {"mega_forward": mk.mega_forward_camera_cuda.launches,
                     "mega_walk_bwd_rays": wbk.mega_walk_backward_cuda.ray_launches}
    log(f"[pose-train] final 1200x675 depth 50, {n_pix:,} rays: loss {loss.item():.6f}, first "
        f"step {wall * 1e3:.1f} ms wall, launches {pose_launches}; d cam_row "
        f"{[round(x, 4) for x in row.grad[:19].tolist()]}")
    require(all(v >= 1 for v in pose_launches.values()),
            f"the pose step skipped a kernel: {pose_launches}")
    require(bool(torch.isfinite(row.grad).all()) and float(row.grad.abs().max()) > 0.0,
            "d cam_row is not finite and nonzero")
    for k, v in p.items():
        require(bool(torch.isfinite(v.grad).all()), f"pose-tracer {k} gradient not finite")

    def pose_step():
        for t in (*p.values(), row):
            t.grad = None
        image_loss(pose(scene_p, row), target).backward()

    pose_step_ms = cuda_ms(pose_step, 3)
    log(f"[time] pose fwd+bwd step {pose_step_ms:.3f} ms ({n_pix / pose_step_ms * 1e3:,.0f} "
        f"rays/s): K6 camera {k6_cam_ms:.3f} ms ({k6_cam_ms / pose_step_ms:.1%}), K8 with ray "
        f"grads {k8r_ms:.3f} ms ({k8r_ms / pose_step_ms:.1%}, lane use {k8r_lane:.4f}; without "
        f"them {k8_off_ms:.3f} ms), "
        f"the rest {pose_step_ms - k6_cam_ms - k8r_ms:.3f} ms")

    return {
        "mega_forward_ray": dict(launches=ray_launches["mega_forward_ray"], max_abs_err=ray_err,
                                 ms=ray_ms, plain_ms=ray_plain_ms, flops=sweep["flops"],
                                 bytes=ray_bytes, lane_use=ray_lane, lane_use_static=ray_static),
        "mega_bwd": dict(launches=ray_launches["mega_bwd"], max_abs_err=k7_err, ms=k7_ms,
                         plain_ms=k7_plain_ms, flops=k7_flops, bytes=k7_bytes,
                         max_norm_err=k7_norm, lane_use=k7_lane, lane_use_static=k7_static),
        "mega_walk_bwd_rays": dict(launches=pose_launches["mega_walk_bwd_rays"],
                                   max_abs_err=k8r_err, ms=k8r_ms, plain_ms=k8r_plain_ms,
                                   flops=k8r_flops, bytes=k8r_bytes, max_norm_err=k8r_norm,
                                   lane_use=k8r_lane, lane_use_static=k8r_static),
        "record": dict(ray_step_ms=ray_step_ms, ray_rays_per_s=RAY_TRACER_RAYS / ray_step_ms
                       * 1e3, k6_ray_ms=ray_ms, k7_ms=k7_ms, ray_tape_rows=rows_ray,
                       k7_rows=k7_rows, ray_sweep=sweep, pose_step_ms=pose_step_ms,
                       pose_rays_per_s=n_pix / pose_step_ms * 1e3, k6_camera_ms=k6_cam_ms,
                       k8_rays_ms=k8r_ms, k8_no_rays_ms=k8_off_ms, k7_vs_k8=k78,
                       k7_lane_use=k7_lane, k8_rays_lane_use=k8r_lane,
                       d_cam_row=row.grad.tolist()),
    }


class EngineBounces:
    """Wraps the fused engine's bounce (render/wavefront.py's `name`,
    fused_bounce or culled_fused_bounce) for one engine run: adds each
    call's counters to `stats` and keeps each call's inputs (the engine
    makes new tensors each bounce, so a reference is a copy), so that the
    run's launches can be replayed."""

    def __init__(self, name: str, device, mid: int = 120):
        from distributed_raytracer_tpu_torch.render import wavefront

        self.module, self.name, self.mid = wavefront, name, mid
        self.inputs = []
        self.stats = torch.zeros(4, dtype=torch.int64, device=device)

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def __call__(self, o, d, live, lane_ray, scene, seed, **kw):
        self.inputs.append((o, d, live, lane_ray, seed))
        return self.real(o, d, live, lane_ray, scene, seed, stats=self.stats)

    def replay_ms(self, kernel) -> float:
        """The card time of the run's launches: each replayed on its
        inputs, back to back, between two CUDA events (kernel_ms; in the
        run itself the card waits for the host between launches), each
        output dropped at once so the allocator reuses its memory."""
        def replay():
            for args in self.inputs:
                kernel(*args)

        return kernel_ms(replay, 1)


def engine_ops_per_block(dev, scene, cam, culled=None) -> float:
    """PyTorch operations the fused engine's host loop issues per block of
    two bounces (refill, the glue around each launch, the drain), counted
    by a dispatch mode over a 1-spp render of cam (the kernel launches
    themselves are not PyTorch operations)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from distributed_raytracer_tpu_torch.render.wavefront import render_wavefront_sum_fused

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    name = "fused_bounce" if culled is None else "culled_fused_bounce"
    with EngineBounces(name, dev) as rec, Count():
        render_wavefront_sum_fused(scene, cam, 1, BOUNCE_SEED, CAM_SEED, culled=culled, device=dev)
    return Count.ops / (len(rec.inputs) / 2)


def log_dense_shape(name: str, shape, reads: str, pool: int) -> None:
    """Log a dense group sweep's (K10, K11) launch shape, as the built
    library reports it, with the blocks and warps per SM of a pool (its
    registers and spills are phase 1's [build] lines)."""
    g, threads = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[dense] {name}'s group sweep: {g} lanes per ray, blocks of {threads} threads, scene "
        f"{reads}; a pool of {pool:,} launches {-(-pool * g // threads):,} blocks, "
        f"{pool * g / 32 / sms:.0f} warps per SM ({sms} SMs)")


def bounce_cost(stats, n_live: int, finite_chunks: int, scene_bytes: int) -> dict:
    """The FP32 operations and bytes fused bounces with these counters
    need: the live-sphere tests at K5's counts (dense: every lane tests
    every live sphere; the walk: the admitted chunks' slot tests), the
    walk's bound test of every finite-bound chunk for every lane, the lanes
    read and written once and the scene read once."""
    lanes, admitted, tests, near = (int(x) for x in stats.tolist())
    live_tests = lanes * n_live if finite_chunks == 0 else tests
    flops = (live_tests * FLOPS_PER_TEST + near * FLOPS_PER_NEAR_TEST
             + lanes * finite_chunks * FLOPS_PER_BOUND_TEST)
    return dict(lanes=lanes, admitted=admitted, tests=live_tests, near=near, flops=flops,
                bytes=lanes * LANE_BYTES + scene_bytes)


def check_fused_path(dev, presets, final, cam_main, k5_main, peak: float) -> dict:
    """Phases 19-23: the fused wavefront engine.  render_progressive
    (engine="fused") at full width, dense (K10) on the final scene and
    culled (K14) on it and on the 8,192-sphere field, each run wrapped to
    keep its pool batches (its launches then replayed for their card time);
    K10 and K14 against their plain versions on three of those batches;
    the engine with a pool holding every ray against K5 and K9; resume;
    the CLI."""
    from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
    from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
    from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import build_culled_scene
    from distributed_raytracer_tpu_torch.render.progressive import AccumState, render_progressive
    from distributed_raytracer_tpu_torch.render.wavefront import (
        DEFAULT_POOL,
        render_wavefront_sum_fused,
    )

    def drive(label, name, counter, kernel, scene, cam, **kw):
        """One engine run through render_progressive at 4 spp, the launch
        count set to 0 before it and read after, its launches then replayed
        through kernel for their card time; returns its numbers and the
        wrapper."""
        counter.launches = 0
        with EngineBounces(name, dev) as rec:
            torch.cuda.synchronize()
            t0 = time.time()
            state = render_progressive(scene, cam, seed=0, spp=4, batch=4, engine="fused", **kw)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
        launches = counter.launches
        kern = rec.replay_ms(kernel)
        n = cam.num_pixels
        img = state.mean_image()
        require(img.shape == (cam.image_height, cam.image_width, 3) and np.isfinite(img).all(),
                f"{label}: image is not finite")
        require(launches >= 1 and launches == len(rec.inputs),
                f"{label}: the engine did not run its kernel ({launches} launches, "
                f"{len(rec.inputs)} bounces)")
        top = img[0, cam.image_width // 2]
        require(top[2] > top[0], f"{label}: top-center pixel not bluish: {top}")
        run = dict(ms_per_sample=wall / 4, rays_per_s=4 * n / wall * 1e3,
                   launches=launches, launches_per_sample=launches / 4,
                   kernel_ms=kern, ms_per_launch=kern / launches,
                   host_share=(wall - kern) / wall, stats=rec.stats.tolist(), tag=state.engine)
        log(f"[fused] {label}: {run['ms_per_sample']:.2f} ms/sample wall, "
            f"{run['rays_per_s']:,.0f} rays/s; {launches} launches "
            f"({run['launches_per_sample']:.1f} per sample), {run['ms_per_launch']:.4f} ms per "
            f"launch (replayed), kernels {kern:.1f} ms of {wall:.1f} ms: host share "
            f"{run['host_share']:.1%}; counters {run['stats']} ({', '.join(bk.STATS)}); "
            f"top-center pixel {top.tolist()}")
        return run, rec

    def hold(label, kernel, plain, rec, group=False):
        """The kernel against its plain version on the run's first, middle
        and last pool batch and on the middle batch's first ODD_LANES
        lanes (a partial block and, at fewer than 32 lanes a pool lane, a
        partial warp of groups): every output and the counters bit for
        bit; with group (K14) the slot-test lanes its groups issue
        counted.  Returns (max abs err, kernel ms, plain ms, counters,
        group lane use or None) at the middle batch, a full pool in the
        steady state."""
        require(rec.mid < len(rec.inputs), f"{label}: the run took {len(rec.inputs)} bounces, "
                f"fewer than {rec.mid + 1}")
        err, plain_ms, use = 0.0, {}, None
        batches = [(at, rec.inputs[at]) for at in (0, rec.mid, len(rec.inputs) - 1)]
        batches.append((f"{rec.mid}, first {ODD_LANES:,} lanes",
                        tuple(x[:ODD_LANES] for x in rec.inputs[rec.mid][:4])
                        + rec.inputs[rec.mid][4:]))
        for at, (o, d, live, lane_ray, seed) in batches:
            st_k, st_p = (torch.zeros(4, dtype=torch.int64, device=dev) for _ in range(2))
            issued = torch.zeros(1, dtype=torch.int64, device=dev)
            got = kernel(o, d, live, lane_ray, seed, stats=st_k,
                         **(dict(issued=issued) if group else {}))
            want, plain_ms[at] = cuda_timed(lambda: plain(o, d, live, lane_ray, seed,
                                                          stats=st_p))
            diff = max(float((getattr(got, k).float() - getattr(want, k).float()).abs().max())
                       for k in bk.BounceOut._fields)
            same = all(torch.equal(getattr(got, k), getattr(want, k))
                       for k in bk.BounceOut._fields)
            lanes = ""
            if group:
                lanes = (f", {int(issued):,} slot-test lanes issued, group lane use "
                         f"{mk.group_lane_use(int(st_k[2]), int(issued)):.4f}")
                if at == rec.mid:
                    use = mk.group_lane_use(int(st_k[2]), int(issued))
            log(f"[fused] {label}, bounce {at} ({int(live.sum()):,} of {live.numel():,} lanes "
                f"live): kernel vs plain max abs err {diff:.3e}, all nine outputs equal bit for "
                f"bit {same}, counters kernel {st_k.tolist()} plain {st_p.tolist()}{lanes}; "
                f"plain {plain_ms[at]:.1f} ms")
            require(same, f"{label}: the kernel differs from its plain version")
            require(torch.equal(st_k, st_p), f"{label}: counters differ from the plain count")
            err = max(err, diff)
        o, d, live, lane_ray, seed = rec.inputs[rec.mid]
        stats = torch.zeros(4, dtype=torch.int64, device=dev)
        kernel(o, d, live, lane_ray, seed, stats=stats)
        ms = kernel_ms(lambda: kernel(o, d, live, lane_ray, seed), 20)
        return err, ms, plain_ms[rec.mid], stats, use

    def row(run, check, n_live, finite, scene_bytes):
        err, ms, plain_ms, stats, use = check
        cost = bounce_cost(stats, n_live, finite, scene_bytes)
        whole = bounce_cost(torch.tensor(run["stats"]), n_live, finite,
                            scene_bytes * run["launches"])
        log(f"[time] {ms:.4f} ms per launch at a full pool ({cost['lanes']:,} lanes, "
            f"{cost['tests']:,} live-sphere tests, {cost['near']:,} with disc >= 0), bound "
            f"{cost['flops'] / peak * 1e3:.4f} ms; the run's {run['launches']} launches "
            f"{run['kernel_ms']:.1f} ms against a bound of {whole['flops'] / peak * 1e3:.2f} ms")
        out = dict(launches=run["launches"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   flops=cost["flops"], bytes=cost["bytes"])
        if use is not None:
            out["group_lane_use"] = use
        return out

    n_main = cam_main.num_pixels
    live_final = int((final.radii > 0).sum())

    # --- phase 19: dense fused engine at the main path, then K10 against plain ---
    log_dense_shape("K10", bk.group_shape(), "staged in shared memory up to 512 spheres, read "
                    "from global memory above", DEFAULT_POOL)
    arrays = bk.fused_scene_arrays(final.to(dev))
    k10_pair = (lambda *a, **k: bk.fused_bounce_cuda(*a[:4], arrays, *a[4:], **k),
                lambda *a, **k: bk.fused_bounce_plain(*a[:4], arrays, *a[4:], **k))
    run_d, rec_d = drive("dense, final 1200x675 depth 50 spp 4, pool 16384", "fused_bounce",
                         bk.fused_bounce_cuda, k10_pair[0], final, cam_main)
    require(run_d["tag"] == "fused", run_d["tag"])
    run_d["ops_per_block"] = engine_ops_per_block(dev, final, cam_main)
    log(f"[fused] the host loop issues {run_d['ops_per_block']:.1f} PyTorch operations per "
        f"block of two bounces (1 spp at 1200x675, counted by a dispatch mode); "
        f"{run_d['ms_per_sample'] / run_d['launches_per_sample'] * 2:.3f} ms wall per block "
        f"in the run")
    chk_d = hold("K10 final", *k10_pair, rec_d)
    scene_bytes_d = final.num_spheres * 15 * 4
    k10 = row(run_d, chk_d, live_final, 0, scene_bytes_d)
    del rec_d

    # --- phase 20: culled fused engine on the final scene and on the field, then K14 ---
    def culled_pair(pack):
        return (lambda *a, **k: cb.culled_fused_bounce_cuda(*a[:4], pack, *a[4:], **k),
                lambda *a, **k: cb.culled_fused_bounce_plain(*a[:4], pack, *a[4:], **k))

    g, threads = cb.group_shape()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[fused] K14's group walk: {g} lanes per pool lane, blocks of {threads} threads; a pool "
        f"of {DEFAULT_POOL:,} lanes launches {-(-DEFAULT_POOL * g // threads):,} blocks, "
        f"{DEFAULT_POOL * g / 32 / sms:.0f} warps per SM ({sms} SMs)")
    culled_f = build_culled_scene(final, chunk=FUSED_CHUNK)
    pack_f = cb.build_culled_pack(culled_f).to(dev)
    run_c, rec_c = drive("culled, final 1200x675 depth 50 spp 4, tiled", "culled_fused_bounce",
                         cb.culled_fused_bounce_cuda, culled_pair(pack_f)[0], culled_f.scene,
                         cam_main, culled=culled_f, ray_order="tiled")
    require(run_c["tag"] == "fused+culled", run_c["tag"])

    def pack_bytes(pack):
        return pack.n_slots * 15 * 4 + pack.n_chunks * (16 + 4)

    def finite(pack):
        return int(torch.isfinite(pack.bounds[:pack.n_chunks, 3]).sum())

    chk_c = hold("K14 final", *culled_pair(pack_f), rec_c, group=True)
    k14 = row(run_c, chk_c, live_final, finite(pack_f), pack_bytes(pack_f))
    del rec_c
    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    cam_big = walk_camera(presets, 1024)
    culled_w = build_culled_scene(field, chunk=FUSED_CHUNK)
    pack_w = cb.build_culled_pack(culled_w).to(dev)
    log(f"[fused] field of {field.num_spheres} spheres: {pack_w.n_chunks} chunks of "
        f"{FUSED_CHUNK}, {pack_w.n_slots} slots, {pack_w.n_chunks - finite(pack_w)} always swept")
    run_w, rec_w = drive("culled, field 1024x576 depth 8 spp 4, tiled", "culled_fused_bounce",
                         cb.culled_fused_bounce_cuda, culled_pair(pack_w)[0], culled_w.scene,
                         cam_big, culled=culled_w, ray_order="tiled")
    chk_w = hold("K14 field", *culled_pair(pack_w), rec_w, group=True)
    k14w = row(run_w, chk_w, int((field.radii > 0).sum()), finite(pack_w), pack_bytes(pack_w))
    del rec_w

    # --- phase 21: a pool holding every ray equals K5 (dense) and K9 (culled) ---
    t0 = time.time()
    full = render_wavefront_sum_fused(final, cam_main, 1, BOUNCE_SEED, CAM_SEED,
                                      pool_size=n_main, device=dev)
    full_c = render_wavefront_sum_fused(final, cam_main, 1, BOUNCE_SEED, CAM_SEED,
                                        pool_size=n_main, culled=culled_f, device=dev)
    walk = mwk.render_wavefront_sum_mega_walk(
        mwk.build_walk_pack(culled_f, cam_main.center.cpu().numpy()), cam_main, 1, BOUNCE_SEED,
        CAM_SEED, device=dev)
    torch.cuda.synchronize()
    log(f"[fused] pool of {n_main:,} (every ray of 1 spp), final 1200x675 depth 50: dense == K5 "
        f"{torch.equal(full, k5_main)} (max abs err {float((full - k5_main).abs().max()):.3e}), "
        f"culled == K9 over the culled scene {torch.equal(full_c, walk)} (max abs err "
        f"{float((full_c - walk).abs().max()):.3e}); {time.time() - t0:.1f} s")
    require(torch.equal(full, k5_main), "the dense fused engine differs from K5 at a full pool")
    require(torch.equal(full_c, walk), "the culled fused engine differs from K9 at a full pool")
    del full, full_c, walk

    # --- phase 22: resume on the fused engine (culled, tiled, re-sorted) ---
    ckpt = ROOT / "build" / "smoke_fused_ckpt.npz"
    ckpt.parent.mkdir(exist_ok=True)
    if ckpt.exists():
        ckpt.unlink()
    kw = dict(seed=7, batch=2, engine="fused", culled=culled_f, ray_order="tiled",
              resort_every=4)
    whole = render_progressive(culled_f.scene, cam_main, spp=4, **kw)
    render_progressive(culled_f.scene, cam_main, spp=2, checkpoint_path=str(ckpt), **kw)
    require(AccumState.load(str(ckpt)).samples_done == 2, "checkpoint does not hold 2 samples")
    resumed = render_progressive(culled_f.scene, cam_main, spp=4, checkpoint_path=str(ckpt), **kw)
    require(resumed.samples_done == 4 and np.array_equal(resumed.raw_sum, whole.raw_sum),
            "the fused engine's resume is not bit-identical")
    log("[fused] resumed 2+2 spp (culled, tiled, re-sorted every 4) equals the uninterrupted 4 "
        "spp render bit for bit")

    # --- phase 23: the CLI on the fused engine with the culled scene ---
    out_ppm = ROOT / "build" / "smoke_fused.ppm"
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", "render", "--config",
         "config5", "--spp", "2", "--engine", "fused", "--accel", "culled", "--resort", "8",
         "--out", str(out_ppm)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"[cli] fused+culled exit {r.returncode} in {time.time() - t0:.1f} s: "
        f"{r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ''}")
    require(r.returncode == 0, r.stderr[-4000:])
    from distributed_raytracer_tpu_torch.render.image import read_ppm

    require(read_ppm(str(out_ppm)).shape == (675, 1200, 3), "CLI PPM is not 1200x675")

    return {
        "fused_bounce": k10, "culled_fused_bounce": k14, "culled_fused_bounce_field": k14w,
        "record": dict(pool=DEFAULT_POOL, dense=run_d, culled=run_c, field=run_w),
    }


class RecordIntersect:
    """Wraps an intersect_fn for one engine run: keeps each call's rays
    (the engine makes new tensors each bounce, so a reference is a copy),
    so that three of the run's batches can be held against the plain
    version and all its launches replayed for their card time."""

    def __init__(self, fn):
        self.fn, self.inputs = fn, []

    def __call__(self, ray_o, ray_d, scene):
        self.inputs.append((ray_o, ray_d))
        return self.fn(ray_o, ray_d, scene)

    def replay_ms(self, launch, prep=lambda o, d: (o, d)) -> float:
        """The card time of the run's launches: launch(*prep(o, d)) for
        each call, the operands prepared first, then the launches back to
        back between two CUDA events (kernel_ms), each output dropped at
        once."""
        args = [prep(o, d) for o, d in self.inputs]

        def replay():
            for a in args:
                launch(*a)

        return kernel_ms(replay, 1)

    def picks(self):
        """The first, middle and last batch of the run."""
        n = len(self.inputs)
        return [self.inputs[i] for i in sorted({0, n // 2, n - 1})]


def engine_ops_per_iteration(dev, scene, cam, intersect_fn) -> float:
    """PyTorch operations the reference wavefront engine issues per
    iteration (one bounce of the pool: the threefry keys and draws, the
    refill, the bounce's intersect glue and shading, the drain), counted
    by a dispatch mode over a 1-spp render of cam (a kernel launch is not
    a PyTorch operation)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.render.wavefront import render_wavefront_sum

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    rec = RecordIntersect(intersect_fn)
    with Count():
        render_wavefront_sum(scene.to(dev), cam.to(dev), prng.PRNGKey(0), 1, intersect_fn=rec)
    return Count.ops / len(rec.inputs)


def closest_hit_cost(n_rays: int, n_live: int, near: int, peak: float, sph_rows: int) -> dict:
    """K11's least time: every ray tests every live sphere (FLOPS_PER_TEST),
    FLOPS_PER_NEAR_TEST more for each test whose discriminant is not
    negative; bytes: the rays read (24 B) and t, idx written (8 B) once,
    the scene (16 B a sphere) once."""
    tests = n_rays * n_live
    flops = tests * FLOPS_PER_TEST + near * FLOPS_PER_NEAR_TEST
    return dict(tests=tests, near=near, flops=flops, bytes=n_rays * 32 + sph_rows * 16,
                bound_ms=max(flops / peak, (n_rays * 32 + sph_rows * 16) / HBM_BYTES_PER_S) * 1e3)


def culled_cost(stats, n_chunks: int, sph_rows: int) -> dict:
    """K12/K13's least time from the launch's counters: its bound tests
    (FLOPS_PER_BOUND_TEST), the slot tests of the chunks it admitted and
    their disc >= 0 share; bytes: the rays in and t, idx out once, the
    scene, the bounds and one plan row per block once."""
    rays, bound_tests, admitted, tests, near = (int(x) for x in stats.tolist())
    flops = (bound_tests * FLOPS_PER_BOUND_TEST + tests * FLOPS_PER_TEST
             + near * FLOPS_PER_NEAR_TEST)
    return dict(rays=rays, bound_tests=bound_tests, admitted=admitted, tests=tests, near=near,
                flops=flops, bytes=rays * 32 + sph_rows * 16 + n_chunks * 20)


def check_reference_path(dev, presets, final, cam_main, peak: float) -> dict:
    """Phases 24-29: the reference bounce and its two engines, with the
    last three TPU kernels.  K11 (csrc/intersect.cu) against its plain
    version on a pool batch of the wavefront engine on the final scene and
    on random rays over the 8,192-sphere field; render_progressive(
    engine="wavefront", use_pallas=True) at the main path with its K11
    launches counted and replayed, the same engine through the plain
    closest hit on the card equal to it bit for bit; K12 and K13
    (csrc/culled_intersect.cu) through the wavefront engine over the
    culled field (--accel culled, tiled) and held to their plain version
    on its batches and on the final scene; the scan engine (render_image)
    at the main path; the CLI on both engines."""
    from distributed_raytracer_tpu_torch import render_image
    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.ops.camera import generate_rays
    from distributed_raytracer_tpu_torch.ops.intersect import HitResult
    from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
    from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.render import wavefront as wf
    from distributed_raytracer_tpu_torch.render.image import read_ppm
    from distributed_raytracer_tpu_torch.render.order import tile_permutation
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    # nothing in the port asks for TF32, so the scan engine's float32
    # matmuls (ops/intersect.py) run in full float32, as JAX's "highest"
    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are switched on")

    def drive(label, scene, cam, fn, counter, **kw):
        """One engine run of render_progressive(engine="wavefront") at 1
        spp, its intersect recorded, the wrapper's count set to 0 before
        it and read after."""
        rec = RecordIntersect(fn)
        counter.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        state = render_progressive(scene, cam, seed=0, spp=1, batch=1, engine="wavefront",
                                   intersect_fn=rec, **kw)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        launches = counter.launches
        img = state.mean_image()
        require(img.shape == (cam.image_height, cam.image_width, 3) and np.isfinite(img).all(),
                f"{label}: image is not finite")
        require(launches >= 1 and launches == len(rec.inputs),
                f"{label}: the engine did not run its kernel ({launches} launches, "
                f"{len(rec.inputs)} bounces)")
        top = img[0, cam.image_width // 2]
        require(top[2] > top[0], f"{label}: top-center pixel not bluish: {top}")
        log(f"[wavefront] {label}: {wall:.1f} ms per sample wall "
            f"({cam.num_pixels / wall * 1e3:,.0f} rays/s), {launches} launches; top-center "
            f"pixel {top.tolist()}")
        return dict(ms_per_sample=wall, rays_per_s=cam.num_pixels / wall * 1e3,
                    launches=launches, tag=state.engine), rec

    # --- phase 24: the wavefront engine with K11 at the main path ---
    log_dense_shape("K11", ik.group_shape(), "read from global memory", wf.DEFAULT_POOL)
    final_dev = final.to(dev)
    sph_f = ik.sphere_pack(final_dev.centers, final_dev.radii)
    live_f = int((final.radii > 0).sum())
    run_k11, rec_k11 = drive("K11 (use_pallas), final 1200x675 depth 50", final, cam_main,
                             ik.closest_hit_pallas, ik.closest_hit_cuda)
    require(run_k11["tag"] == "wavefront", run_k11["tag"])
    kern = rec_k11.replay_ms(ik.closest_hit_cuda, lambda o, d: (o, d, sph_f))
    run_k11.update(kernel_ms=kern, ms_per_launch=kern / run_k11["launches"],
                   host_share=(run_k11["ms_per_sample"] - kern) / run_k11["ms_per_sample"])
    run_k11["ops_per_iteration"] = engine_ops_per_iteration(
        dev, final, presets.final_scene_camera(120), ik.closest_hit_pallas)
    log(f"[wavefront] K11's {run_k11['launches']} launches replayed: {kern:.1f} ms of "
        f"{run_k11['ms_per_sample']:.1f} ms, host share {run_k11['host_share']:.1%}; "
        f"{run_k11['ops_per_iteration']:.1f} PyTorch operations per iteration (one bounce; "
        f"counted by a dispatch mode at 120x67)")

    # --- phase 25: K11 against its plain version, bit for bit ---
    def hold_k11(label, o, d, sph, n_live):
        """K11 against its plain version: t, idx and the count of tests
        with disc >= 0 bit for bit."""
        stats, st_p = (torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2))
        t_k, i_k = ik.closest_hit_cuda(o, d, sph, stats=stats)
        (t_p, i_p), plain_ms = cuda_timed(lambda: ik.closest_hit_plain(o, d, sph, stats=st_p))
        same = torch.equal(t_k, t_p) and torch.equal(i_k, i_p) and torch.equal(stats, st_p)
        err = float((t_k - t_p).abs().max())
        ms = kernel_ms(lambda: ik.closest_hit_cuda(o, d, sph), 50)
        cost = closest_hit_cost(o.shape[0], n_live, int(stats), peak, sph.shape[0])
        log(f"[k11] {label}: {o.shape[0]:,} rays x {n_live} live spheres, kernel == plain bit "
            f"for bit {same} (t max abs err {err:.3e}; disc >= 0 tests kernel {int(stats):,}, "
            f"plain {int(st_p):,}); {ms:.4f} ms per launch, bound "
            f"{cost['bound_ms']:.4f} ms ({cost['tests']:,} tests, {cost['near']:,} with "
            f"disc >= 0), plain {plain_ms:.2f} ms")
        require(same, f"{label}: K11 differs from its plain version")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **cost)

    for o, d in rec_k11.picks():
        hold_k11("pool batch, final", o, d, sph_f, live_f)
    o_m, d_m = rec_k11.inputs[len(rec_k11.inputs) // 2]
    hold_k11(f"pool batch (middle), first {ODD_LANES:,} rays, final", o_m[:ODD_LANES],
             d_m[:ODD_LANES], sph_f, live_f)
    k11 = hold_k11("pool batch (middle), final", o_m, d_m, sph_f, live_f)
    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    field_dev = field.to(dev)
    sph_w = ik.sphere_pack(field_dev.centers, field_dev.radii)
    g = torch.Generator().manual_seed(11)
    o_r = ((torch.rand(16384, 3, generator=g) * 2.0 - 1.0) * 40.0).to(dev)
    d_r = torch.randn(16384, 3, generator=g).to(dev)
    k11["field"] = hold_k11("random rays, field", o_r, d_r, sph_w, int((field.radii > 0).sum()))
    del rec_k11

    # the same engine through the plain closest hit on the card: the same
    # keys and the same function, so the same sums bit for bit
    def plain_hit(ray_o, ray_d, scene):
        t, idx = ik.closest_hit_plain(ray_o, ray_d, ik.sphere_pack(scene.centers, scene.radii))
        return HitResult(t=t, idx=idx, hit=t < 0.5e30)

    cam_small = presets.final_scene_camera(300)
    key = prng.fold_in(prng.PRNGKey(0), 0)
    with_k11 = wf.render_wavefront_sum(final_dev, cam_small.to(dev), key, 1,
                                       intersect_fn=ik.closest_hit_pallas)
    with_plain = wf.render_wavefront_sum(final_dev, cam_small.to(dev), key, 1,
                                         intersect_fn=plain_hit)
    torch.cuda.synchronize()
    log(f"[wavefront] final 300x168 depth 50: K11 run == plain-closest-hit run bit for bit "
        f"{torch.equal(with_k11, with_plain)}")
    require(torch.equal(with_k11, with_plain), "the K11 engine run differs from the plain one")

    # --- phase 26: K12 (--accel culled) and K13 over the field, tiled ---
    g, threads = ck.group_shape()
    log(f"[wavefront] K12/K13's group walk: {g} lanes per ray, blocks of {threads} threads; a "
        f"pool batch of {wf.DEFAULT_POOL:,} rays launches "
        f"{-(-wf.DEFAULT_POOL * g // threads):,} blocks")
    cam_big = walk_camera(presets, 1024)
    culled_w = ck.build_culled_scene(field, chunk=FUSED_CHUNK)
    runs, recs = {}, {}
    for mode, counter in (("grid", ck.culled_closest_hit_cuda),
                          ("walk", ck.culled_closest_hit_walk_cuda)):
        runs[mode], recs[mode] = drive(f"K{12 if mode == 'grid' else 13} ({mode}), field 1024x576 depth 8, "
                           "tiled", culled_w.scene, cam_big,
                           ck.make_culled_intersect(culled_w, mode=mode), counter,
                           ray_order="tiled")

    # --- phase 27: K12 and K13 against their plain version, bit for bit ---
    def hold_culled(label, culled, o, d, walk):
        csc = culled.scene.to(dev)
        sph = ik.sphere_pack(csc.centers, csc.radii)
        br, nb = ck.plan_blocks(o.shape[0])
        order, n_visit = ck.block_visit_plan(o, d, torch.from_numpy(culled.bounds_c).to(dev),
                                             torch.from_numpy(culled.bounds_r2).to(dev), nb, br)
        bounds = ck.culled_bounds(culled, dev)
        launch = ck.culled_closest_hit_walk_cuda if walk else ck.culled_closest_hit_cuda
        args = (o, d, sph, bounds, order, n_visit, culled.chunk, br)
        stats = torch.zeros(len(ck.CULLED_STATS), dtype=torch.int64, device=dev)
        issued = torch.zeros(1, dtype=torch.int64, device=dev)
        t_k, i_k = launch(*args, stats=stats, issued=issued)
        (t_p, i_p), plain_ms = cuda_timed(
            lambda: ck.culled_closest_hit_plain(o, d, sph, order, culled.chunk, br))
        same = torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
        ms = kernel_ms(lambda: launch(*args), 20)
        n_chunks = order.shape[1]
        cost = culled_cost(stats, n_chunks, sph.shape[0])
        dense = o.shape[0] * sph.shape[0]  # K11's tests over the culled scene's slots
        use = mk.group_lane_use(cost["tests"], int(issued))
        log(f"[k1{3 if walk else 2}] {label}: {o.shape[0]:,} rays, {n_chunks} chunks of "
            f"{culled.chunk}, plan visits {float(n_visit.float().mean()):.1f} per block; kernel "
            f"== plain bit for bit {same}; {ms:.4f} ms per launch, bound "
            f"{cost['flops'] / peak * 1e3:.4f} ms ({cost['bound_tests']:,} bound tests, "
            f"{cost['admitted']:,} chunks admitted, {cost['tests']:,} slot tests = "
            f"{cost['tests'] / dense:.1%} of a dense sweep's, {cost['near']:,} with disc >= 0; "
            f"{int(issued):,} slot-test lanes issued, group lane use {use:.4f}), "
            f"plain {plain_ms:.2f} ms")
        require(same, f"{label}: the culled kernel differs from its plain version")
        require(cost["rays"] == o.shape[0], f"{label}: the kernel counted {cost['rays']} rays")
        return dict(max_abs_err=float((t_k - t_p).abs().max()), ms=ms, plain_ms=plain_ms,
                    admitted_share=cost["tests"] / dense, group_lane_use=use, **cost)

    rows = {}
    for mode in ("grid", "walk"):
        run, rec = runs[mode], recs.pop(mode)
        for o, d in rec.picks():
            hold_culled(f"{mode}, field pool batch", culled_w, o, d, mode == "walk")
        o_m, d_m = rec.inputs[len(rec.inputs) // 2]
        hold_culled(f"{mode}, field pool batch (middle), first {ODD_LANES:,} rays", culled_w,
                    o_m[:ODD_LANES], d_m[:ODD_LANES], mode == "walk")
        rows[mode] = hold_culled(f"{mode}, field pool batch (middle)", culled_w, o_m, d_m,
                                 mode == "walk")
        bounds = ck.culled_bounds(culled_w, dev)
        bc = torch.from_numpy(culled_w.bounds_c).to(dev)
        br2 = torch.from_numpy(culled_w.bounds_r2).to(dev)
        csc = culled_w.scene.to(dev)
        sph = ik.sphere_pack(csc.centers, csc.radii)
        launch = ck.culled_closest_hit_walk_cuda if mode == "walk" else ck.culled_closest_hit_cuda

        def prep(o, d):
            br, nb = ck.plan_blocks(o.shape[0])
            order, n_visit = ck.block_visit_plan(o, d, bc, br2, nb, br)
            return o, d, sph, bounds, order, n_visit, culled_w.chunk, br

        kern = rec.replay_ms(launch, prep)
        run.update(kernel_ms=kern, ms_per_launch=kern / run["launches"],
                   host_share=(run["ms_per_sample"] - kern) / run["ms_per_sample"])
        log(f"[wavefront] {mode}: the run's {run['launches']} launches replayed: {kern:.1f} ms "
            f"of {run['ms_per_sample']:.1f} ms, host share {run['host_share']:.1%}")
        del rec
    culled_f = ck.build_culled_scene(final, chunk=FUSED_CHUNK)
    ids = torch.as_tensor(tile_permutation(cam_main.image_width, cam_main.image_height)[:16384],
                          device=dev)
    o_f, d_f = generate_rays(cam_main.to(dev), ids % cam_main.image_width,
                             ids // cam_main.image_width, key=prng.PRNGKey(1))
    for mode in ("grid", "walk"):
        rows[mode]["final"] = hold_culled(f"{mode}, final camera rays (first 16,384 in tiles)",
                                          culled_f, o_f, d_f, mode == "walk")

    # --- phase 28: the scan engine at the main path ---
    torch.cuda.synchronize()
    t0 = time.time()
    img = render_image(final, cam_main, seed=0, spp=1)
    torch.cuda.synchronize()
    scan_ms = (time.time() - t0) * 1e3
    h, w = cam_main.image_height, cam_main.image_width
    require(img.shape == (h, w, 3) and np.isfinite(img).all(),
            f"scan image of shape {img.shape} is not a finite {h}x{w}x3 image")
    top = img[0, w // 2]
    require(top[2] > top[0], f"scan: top-center pixel not bluish {top}")
    log(f"[scan] render_image final 1200x675 depth 50 spp 1: {scan_ms:.1f} ms "
        f"({cam_main.num_pixels / scan_ms * 1e3:,.0f} rays/s; no kernel: the reference bounce "
        f"in plain PyTorch, tiles of 32,768 rays); top-center pixel {top.tolist()}")

    # --- phase 29: the CLI on the reference engines ---
    for args in (["--engine", "wavefront", "--pallas"], ["--engine", "scan"]):
        out_ppm = ROOT / "build" / f"smoke_{args[1]}.ppm"
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", "render", "--config",
             "config5", "--spp", "1", *args, "--out", str(out_ppm)], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        log(f"[cli] {' '.join(args)} exit {r.returncode} in {time.time() - t0:.1f} s: "
            f"{r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ''}")
        require(r.returncode == 0, r.stderr[-4000:])
        require(read_ppm(str(out_ppm)).shape == (675, 1200, 3), "CLI PPM is not 1200x675")

    def row(check, launches):
        return dict(launches=launches, **{k: check[k] for k in (
            "max_abs_err", "ms", "plain_ms", "flops", "bytes", "group_lane_use") if k in check})

    return {
        "closest_hit": row(k11, run_k11["launches"]),
        "culled_closest_hit": row(rows["grid"], runs["grid"]["launches"]),
        "culled_closest_hit_walk": row(rows["walk"], runs["walk"]["launches"]),
        "record": dict(wavefront_k11=run_k11, k11=k11, culled=runs, culled_checks=rows,
                       scan_ms_per_sample=scan_ms),
    }


# the host-loop tape tracer's configuration on the training phases
# (bench.py:193-243): pool, refill block, tape budget, and the key
TAPE_POOL, TAPE_REFILL, TAPE_BUDGET = 2048, 2, 704
# two training runs that differ only by a kernel against its plain version
# give the same tape bit for bit; their gradients part by the order of the
# backward's index_add_ atomics alone, each field normalized by its max
TRAIN_GRAD_BAND = 1e-4


class RecordCalls:
    """Wraps module.name (a kernel wrapper the tracers call) for one run:
    keeps each call's arguments, so the run's launches can be replayed;
    plain=fn routes the calls to fn instead (the plain version)."""

    def __init__(self, module, name: str, plain=None):
        self.module, self.name, self.plain, self.calls = module, name, plain, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def __call__(self, *args, **kw):
        self.calls.append(args)
        return (self.plain or self.real)(*args, **kw)

    # a wrapper that counts its launches on its own name counts on the real one
    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, value):
        self.real.launches = value

    def replay_ms(self, launch, prep=lambda *a: a) -> float:
        args = [prep(*a) for a in self.calls]

        def replay():
            for a in args:
                launch(*a)

        return kernel_ms(replay, 1)


def grad_band(label, got: dict, want: dict, band: float) -> float:
    """Each field's gradients against the reference run's, normalized by
    its max; returns the largest."""
    worst = 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max()) / (float(w.abs().max()) + 1e-30)
        worst = max(worst, err)
    log(f"[train] {label}: gradients within {worst:.3e} of the reference run's (band "
        f"{band:g}, each field normalized by its max)")
    require(worst <= band, f"{label}: gradients part from the reference run's by {worst:.3e}")
    return worst


def check_training_paths(dev, presets, final, cam_main) -> dict:
    """Phases 30-34: the training paths of the host-loop tape tracer, the
    path-replay tracer and diff_render, which run K10, K11 and K12/K13.
    (a) make_tape_tracer(use_mega=False) with K11 on 262,144 rays strided
    over 1200x675 (bench.py:193-243: pool 2,048, refill every 2, budget 704
    with its worst-case fallback), image_loss(...).backward(), colors, n_it
    and tape bit for bit against the same step with K11's plain version,
    gradients within TRAIN_GRAD_BAND; (b) the same with use_fused (K10);
    (c) the 8,192-sphere field at 1024x576 depth 8 with K12 and K13; (d)
    make_pathgrad_tracer (scan, wavefront, fused) on the 262,144 rays and
    make_image_grad_fn on all 810,000 pixels, colors and _Step records bit
    for bit against the same step with the kernel's plain version, loss
    equal, gradients within the band; (e) InverseRenderer(engine="tape") at
    1200x675, its first step's loss and tape bit for bit and its albedo
    gradient within the band against the plain K10's, then the CLI's
    grad-check and invert.  Each kernel's count is set to 0 just before a
    path runs and read just after; its launches are replayed for their card
    time."""
    from distributed_raytracer_tpu_torch import (
        InverseRenderer,
        image_loss,
        make_image_grad_fn,
        make_pathgrad_tracer,
        make_tape_tracer,
    )
    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.grad import pathgrad as tpg
    from distributed_raytracer_tpu_torch.grad import tapegrad as ttg
    from distributed_raytracer_tpu_torch.ops.camera import generate_rays
    from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
    from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
    from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    def strided_rays(cam, n_rays):
        """n_rays camera rays strided over the whole image, from generate_rays
        on PRNGKey(0) (bench.py:209-216)."""
        n_pix, w = cam.num_pixels, cam.image_width
        ids = torch.from_numpy(np.arange(n_rays, dtype=np.int64) * n_pix // n_rays).to(dev)
        return generate_rays(cam.to(dev), ids % w, ids // w, key=prng.PRNGKey(0))

    def step(tracer, scene, o, d, *extra):
        """One training step through the entry point: colors, image_loss
        against zeros, backward; returns (colors, the five fields'
        gradients, wall ms)."""
        p = {k: v.detach().clone().requires_grad_() for k, v in scene.diff_params().items()}
        torch.cuda.synchronize()
        t0 = time.time()
        colors = tracer(scene.with_diff_params(p), o, d, *extra)
        image_loss(colors, torch.zeros_like(colors)).backward()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        require(bool(torch.isfinite(colors).all()), "training colors are not finite")
        for k, v in p.items():
            require(bool(torch.isfinite(v.grad).all()), f"{k} gradient not finite")
        require(float(p["albedo"].grad.abs().max()) > 0.0, "albedo gradient is zero")
        return colors.detach(), {k: v.grad for k, v in p.items()}, wall

    class Capture(RecordCalls):
        """Keeps the output of module.name's last call (a recording forward)."""

        def __init__(self, module, name):
            super().__init__(module, name)
            self.out = None

        def __call__(self, *args, **kw):
            self.out = self.real(*args, **kw)
            return self.out

    def same_bits(a, b) -> bool:
        """The same shape and bits (floats compared as their int32 words)."""
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and torch.equal(a, b)

    def both_arms(label, run, swap, fwd):
        """run(arm) with the kernel (its launches counted) and again with its
        plain version in the kernel's wrapper's place: per arm, run's result,
        the last output of the recording forward fwd = (module, name), the
        launches and the recorded calls.  swap = (module, wrapper name, plain
        version, counter); run(arm) makes its tracer itself, inside the swap,
        so an intersect that binds its launcher when made binds the swapped
        one."""
        module, name, plain, counter = swap
        out = {}
        for arm in ("kernel", "plain"):
            with Capture(*fwd) as cap, RecordCalls(module, name,
                                                   plain if arm == "plain" else None) as rec:
                counter.launches = 0
                res = run(arm)
            out[arm] = dict(res=res, fwd=cap.out, launches=counter.launches, rec=rec)
        k, p = out["kernel"], out["plain"]
        require(k["launches"] >= 1 and k["launches"] == len(k["rec"].calls),
                f"{label}: {k['launches']} launches for {len(k['rec'].calls)} calls")
        require(p["launches"] == 0, f"{label}: the plain run launched the kernel")
        return k, p

    def same_tape_fwd(label, k, p):
        """The host-loop forwards of two arms: colors, n_it, pos and tape bit
        for bit; returns n_it."""
        (col_k, tape_k, n_it, pos_k), (col_p, tape_p, n_it_p, pos_p) = k["fwd"], p["fwd"]
        same = (n_it == n_it_p and same_bits(col_k, col_p) and torch.equal(pos_k, pos_p)
                and same_bits(tape_k.idata, tape_p.idata)
                and same_bits(tape_k.fdata, tape_p.fdata))
        require(k["launches"] == n_it, f"{label}: {k['launches']} launches for {n_it} tape rows")
        log(f"[train] {label}: n_it {n_it}, {k['launches']} launches; kernel run == plain run "
            f"bit for bit (colors, n_it, pos, tape) {same}")
        require(same, f"{label}: the kernel's training run differs from the plain one")
        return n_it

    def tape_run(label, scene, o, d, key, counter, swap, make_kw):
        """The host-loop tape tracer's step with its kernel (counted) and
        again with swap's plain version: colors, n_it, pos and tape bit for
        bit, gradients within the band; the kernel's launches replayed.
        swap = (module, wrapper name, plain version, launch, prep); the
        tracer's arguments are made by make_kw() inside the swap."""
        module, name, plain, launch, prep = swap
        k, p = both_arms(label, lambda arm: step(make_tape_tracer(key, **make_kw()), scene, o, d),
                         (module, name, plain, counter), (ttg, "_forward_tape"))
        n_it = same_tape_fwd(label, k, p)
        (_, grads_k, wall), (_, grads_p, wall_p) = k["res"], p["res"]
        band = grad_band(label, grads_k, grads_p, TRAIN_GRAD_BAND)
        kern = k["rec"].replay_ms(launch, prep)
        log(f"[time] {label}: fwd+bwd step {wall:.1f} ms wall "
            f"({o.shape[0] / wall * 1e3:,.0f} rays/s), plain-kernel step "
            f"{wall_p:.1f} ms; the kernel's {k['launches']} launches replayed {kern:.2f} ms, "
            f"host share {(wall - kern) / wall:.1%}")
        return dict(n_it=n_it, launches=k["launches"], ms_per_step=wall,
                    plain_ms_per_step=wall_p, kernel_ms=kern,
                    host_share=(wall - kern) / wall, grad_err=band)

    final_dev = final.to(dev)
    o_s, d_s = strided_rays(cam_main, RAY_TRACER_RAYS)
    depth = cam_main.max_depth
    tape_kw = dict(max_depth=depth, pool=TAPE_POOL, refill_every=TAPE_REFILL)
    key1 = prng.PRNGKey(1)
    rec = {}

    def budget_for(**kw):
        """bench.py:229-242: the trip count of one untimed forward at the
        tight budget; the worst-case tape (None) if it comes within 20%."""
        _, _, n_it, _ = ttg._forward_tape(final_dev, o_s, d_s, key1, depth, TAPE_POOL,
                                          budget=TAPE_BUDGET, refill_every=TAPE_REFILL, **kw)
        tight = n_it * 1.2 < TAPE_BUDGET
        log(f"[train] tape trip count {n_it} / budget {TAPE_BUDGET}"
            + ("" if tight else " -> the worst-case tape"))
        return TAPE_BUDGET if tight else None

    # --- phase 30 (a): the host-loop tape tracer with K11 ---
    budget = budget_for(intersect_fn=ik.closest_hit_pallas)
    rec["tape_k11"] = tape_run(
        f"(a) tape tracer, K11, final, {RAY_TRACER_RAYS:,} strided rays depth 50", final_dev,
        o_s, d_s, key1, ik.closest_hit_cuda,
        (ik, "closest_hit_dense", ik.closest_hit_plain, ik.closest_hit_cuda,
         lambda o, d, sph: (o.contiguous(), d.contiguous(), sph)),
        lambda: dict(intersect_fn=ik.closest_hit_pallas, budget=budget, **tape_kw))

    # --- phase 31 (b): the same tracer with use_fused (K10) ---
    budget = budget_for(use_fused=True)
    rec["tape_k10"] = tape_run(
        f"(b) tape tracer, use_fused K10, final, {RAY_TRACER_RAYS:,} strided rays depth 50",
        final_dev, o_s, d_s, key1, bk.fused_bounce_cuda,
        (ttg, "fused_bounce", bk.fused_bounce_plain, bk.fused_bounce_cuda, lambda *a: a),
        lambda: dict(use_fused=True, budget=budget, **tape_kw))

    # --- phase 32 (c): the 8,192-sphere field with K12 and K13 ---
    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    cam_w = walk_camera(presets, 1024)
    culled_w = ck.build_culled_scene(field, chunk=FUSED_CHUNK)
    scene_w = culled_w.scene.to(dev)
    o_w, d_w = strided_rays(cam_w, cam_w.num_pixels)
    for mode, counter in (("grid", ck.culled_closest_hit_cuda),
                          ("walk", ck.culled_closest_hit_walk_cuda)):
        name = "culled_closest_hit_walk_cuda" if mode == "walk" else "culled_closest_hit_cuda"

        def culled_plain(o, d, sph, bnd, order, n_visit, chunk, br):
            return ck.culled_closest_hit_plain(o, d, sph, order, chunk, br)

        rec[f"tape_k1{2 if mode == 'grid' else 3}"] = tape_run(
            f"(c) tape tracer, K1{2 if mode == 'grid' else 3} ({mode}), field 1024x576 "
            f"depth 8, {cam_w.num_pixels:,} rays, pool 16,384", scene_w, o_w, d_w, key1,
            counter, (ck, name, culled_plain, counter, lambda *a: a),
            lambda: dict(intersect_fn=ck.make_culled_intersect(culled_w, mode=mode),
                         max_depth=cam_w.max_depth, pool=16384))

    # --- phase 33 (d): the path-replay tracer, then make_image_grad_fn ---
    k11_swap = (ik, "closest_hit_dense", ik.closest_hit_plain, ik.closest_hit_cuda)
    k10_swap = (tpg, "fused_bounce", bk.fused_bounce_plain, bk.fused_bounce_cuda)
    k11_replay = (ik.closest_hit_cuda, lambda o, d, sph: (o.contiguous(), d.contiguous(), sph))
    k10_replay = (bk.fused_bounce_cuda, lambda *a: a)
    primal_fwd = {"scan": "_forward_scan", "wavefront": "_forward_wavefront",
                  "fused": "_forward_scan_fused"}

    def replayed(label, rec, replay, wall, launches):
        """The run's launches replayed for their card time; logs the host
        share."""
        kern = rec.replay_ms(*replay)
        log(f"[time] {label}: {launches} launches replayed {kern:.2f} ms of {wall:.1f} ms "
            f"wall, host share {(wall - kern) / wall:.1%}")
        return dict(kernel_ms=kern, host_share=(wall - kern) / wall)

    def same_steps(label, k, p, n_rays):
        """The path-replay forwards of two arms: colors and _Step records bit
        for bit."""
        (col_k, steps_k), (col_p, steps_p) = k["fwd"], p["fwd"]
        same = same_bits(col_k, col_p) and all(same_bits(a, b) for a, b in zip(steps_k, steps_p))
        log(f"[train] {label}: kernel run == plain run bit for bit (colors and _Step records, "
            f"all {n_rays:,} rays) {same}")
        require(same, f"{label}: the kernel's forward differs from the plain one")

    paths = {}
    for primal in ("scan", "wavefront", "fused"):
        label = f"(d) pathgrad primal={primal}"
        kern_name = "K10" if primal == "fused" else "K11"
        k, p = both_arms(
            label, lambda arm: step(make_pathgrad_tracer(
                key1, depth, intersect_fn=ik.closest_hit_pallas, primal=primal), final_dev, o_s,
                d_s),
            k10_swap if primal == "fused" else k11_swap, (tpg, primal_fwd[primal]))
        same_steps(label, k, p, RAY_TRACER_RAYS)
        (colors, grads, wall), (_, grads_p, wall_p) = k["res"], p["res"]
        launches = k["launches"]
        paths[primal] = dict(colors=colors, grads=grads, ms_per_step=wall,
                             plain_ms_per_step=wall_p, launches=launches,
                             grad_err=grad_band(label, grads, grads_p, TRAIN_GRAD_BAND))
        log(f"[train] {label}, final, {RAY_TRACER_RAYS:,} strided rays depth 50: fwd+bwd "
            f"{wall:.1f} ms wall ({RAY_TRACER_RAYS / wall * 1e3:,.0f} rays/s), plain-kernel "
            f"step {wall_p:.1f} ms, n_it {launches} forward rows, {launches} {kern_name} "
            f"launches")
        paths[primal].update(replayed(f"(d) pathgrad {primal}", k["rec"],
                                      k10_replay if primal == "fused" else k11_replay, wall,
                                      launches))
        del k, p
    same = torch.equal(paths["scan"]["colors"], paths["wavefront"]["colors"])
    log(f"[train] (d) wavefront primal == scan primal bit for bit {same}")
    require(same, "the wavefront primal differs from the scan primal")
    paths["wavefront_vs_scan_grad_err"] = grad_band(
        "(d) pathgrad wavefront vs scan", paths["wavefront"]["grads"], paths["scan"]["grads"],
        TRAIN_GRAD_BAND)

    def image_grad(arm):
        grad_fn = make_image_grad_fn(cam_main, pool_divisor=8, intersect_fn=ik.closest_hit_pallas)
        torch.cuda.synchronize()
        t0 = time.time()
        loss, grads = grad_fn(final_dev, torch.zeros(cam_main.num_pixels, 3, device=dev), [0])
        torch.cuda.synchronize()
        return loss, grads, (time.time() - t0) * 1e3

    label = "(d) make_image_grad_fn"
    k, p = both_arms(label, image_grad, k11_swap, (tpg, "_forward_scan"))
    same_steps(label, k, p, cam_main.num_pixels)
    (loss, grads, wall), (loss_p, grads_p, wall_p) = k["res"], p["res"]
    launches = k["launches"]
    require(np.isfinite(float(loss)) and all(bool(torch.isfinite(g).all())
                                             for g in grads.values()),
            "make_image_grad_fn: loss or gradients not finite")
    require(same_bits(loss, loss_p), f"{label}: loss {float(loss)} differs from the plain "
            f"run's {float(loss_p)}")
    paths["image_grad"] = dict(ms=wall, plain_ms=wall_p, launches=launches, loss=float(loss),
                               grad_err=grad_band(label, grads, grads_p, TRAIN_GRAD_BAND))
    log(f"[train] {label}, final 1200x675 depth 50, 1 sample: loss {float(loss):.6f} (plain "
        f"run's equal), {wall:.1f} ms wall ({cam_main.num_pixels / wall * 1e3:,.0f} rays/s), "
        f"plain-kernel {wall_p:.1f} ms, n_it {launches} forward rows, {launches} K11 launches")
    paths["image_grad"].update(replayed(label, k["rec"], k11_replay, wall, launches))
    rec["pathgrad"] = {k: ({kk: vv for kk, vv in v.items() if kk not in ("colors", "grads")}
                           if isinstance(v, dict) else v) for k, v in paths.items()}
    del paths, k, p

    # --- phase 34 (e): InverseRenderer(engine="tape") with K10, then the CLI ---
    true = render_progressive(final, cam_main, seed=3, spp=1, batch=1, engine="mega")
    target = torch.from_numpy(true.mean_image().reshape(-1, 3)).to(dev)
    noise = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, (final.num_spheres, 3))
                             .astype(np.float32))
    start = final.with_diff_params({"albedo": torch.clamp(final.albedo + noise, 0.05, 0.95)})
    invs = {}

    def inverse_step(arm):
        """One step of the arm's InverseRenderer (made at its first step):
        (loss, albedo gradient, wall ms)."""
        if arm not in invs:
            invs[arm] = InverseRenderer(start, cam_main, target, fields=("albedo",),
                                        spp_per_step=1, engine="tape")
        inv = invs[arm]
        torch.cuda.synchronize()
        t0 = time.time()
        loss = inv.step()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        (albedo,) = inv.opt.param_groups[0]["params"]
        return loss, albedo.grad.clone(), wall

    label = "(e) InverseRenderer step 0"
    k, p = both_arms(label, inverse_step, (ttg, "fused_bounce", bk.fused_bounce_plain,
                                           bk.fused_bounce_cuda), (ttg, "_forward_tape"))
    same_tape_fwd(label, k, p)
    (loss, g_alb, wall), (loss_p, g_alb_p, wall_p) = k["res"], p["res"]
    require(np.isfinite(loss) and loss == loss_p,
            f"{label}: loss {loss} against the plain run's {loss_p}")
    grad_err = grad_band(label, {"albedo": g_alb}, {"albedo": g_alb_p}, TRAIN_GRAD_BAND)
    inv_steps = [dict(loss=loss, ms=wall, plain_ms=wall_p, launches=k["launches"],
                      grad_err=grad_err, rec=k["rec"])]
    del k, p, invs["plain"]
    # step 1 on the kernel arm's renderer, after its Adam step
    bk.fused_bounce_cuda.launches = 0
    with RecordCalls(ttg, "fused_bounce") as rc:
        loss, _, wall = inverse_step("kernel")
    launches = bk.fused_bounce_cuda.launches
    require(np.isfinite(loss) and launches >= 1 and launches == len(rc.calls),
            f"InverseRenderer step 1: loss {loss}, {launches} K10 launches")
    inv_steps.append(dict(loss=loss, ms=wall, launches=launches, rec=rc))
    for i, st in enumerate(inv_steps):
        log(f"[train] (e) InverseRenderer(engine='tape') final 1200x675 depth 50, step {i}: "
            f"loss {st['loss']:.6f}" + (" (plain run's equal)" if i == 0 else "")
            + f", {st['ms']:.1f} ms wall"
            + (f" (plain-kernel {st['plain_ms']:.1f} ms)" if i == 0 else "")
            + f", n_it {st['launches']} tape rows, {st['launches']} K10 launches")
        st.update(replayed(f"(e) InverseRenderer step {i}", st.pop("rec"), k10_replay, st["ms"],
                           st["launches"]))
    rec["inverse"] = inv_steps
    del invs
    for args in (["grad-check"], ["invert", "--steps", "3"]):
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", *args, "--config",
             "config1", "--width", "64"], cwd=ROOT, capture_output=True, text=True, timeout=600)
        tail = r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ""
        log(f"[cli] {' '.join(args)} exit {r.returncode} in {time.time() - t0:.1f} s: {tail}")
        require(r.returncode == 0, r.stderr[-4000:])
        require("finite=False" not in r.stderr and ("loss:" in r.stderr
                                                    or "final albedo MAE" in r.stderr),
                f"cli {args[0]}: {r.stderr[-2000:]}")

    launches = {
        "fused_bounce": {"tape (b)": rec["tape_k10"]["launches"],
                         "pathgrad fused (d)": rec["pathgrad"]["fused"]["launches"],
                         "InverseRenderer (e)": inv_steps[-1]["launches"]},
        "closest_hit": {"tape (a)": rec["tape_k11"]["launches"],
                        "pathgrad scan (d)": rec["pathgrad"]["scan"]["launches"],
                        "pathgrad wavefront (d)": rec["pathgrad"]["wavefront"]["launches"],
                        "image grad (d)": rec["pathgrad"]["image_grad"]["launches"]},
        "culled_closest_hit": {"tape (c)": rec["tape_k12"]["launches"]},
        "culled_closest_hit_walk": {"tape (c)": rec["tape_k13"]["launches"]},
    }
    return dict(training_launches=launches, record=rec)


# the scene-sharded phase's mesh (2 ray shards x 2 scene shards) and the
# pool batch of rays its closest hit is held on
SHARD_RAYS, SHARD_SCENE = 2, 2
SHARD_POOL = 16384
# seconds a worker of the scene-sharded phase may take
WORKER_TIMEOUT_S = 300
# the ray-sharded phases' world sizes: 4 as asked of the main path, 7
# because it does not divide 1200x675 (the last shard is short)
DP_WORLDS = (4, 7)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_distributed_path(dev, presets, final, cam_main, k5_ms: float,
                           main_ms_per_sample: float) -> dict:
    """Phases 35-39: the distributed layer (parallel/) on the card.
    (a) make_mega_dp_render (K5 at each shard's pix0, n_valid, n_cap and
    n_global) at worlds 4 and 7, rank by rank in one process, equal to the
    single-device render_wavefront_sum_mega sum bit for bit, a short shard
    held against K5's plain version; then render-dist --engine mega at
    world size 1 on NCCL through the CLI, its PPM equal byte for byte to the
    single-device sum's at the seeds of PRNGKey(0).  (b) the camera dp
    tracer (K6, K8) on the 810,000-pixel step and the walk dp tracer (K9
    record, K8) on the 8,192-sphere field, colors bit for bit with the
    single-device tracers, the summed gradients in TRAIN_GRAD_BAND.  (c)
    make_fused_dp_render (K10 dense, K14 culled) at world 4, each shard
    equal to a single-device run at its fold_in seeds.  (d) the
    scene-sharded render, 2 x 2 gloo processes on this card (K11 the local
    sweep).  (e) export-scene, then render --scene: the preset's image."""
    from distributed_raytracer_tpu_torch import cli
    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.grad.diff_render import image_loss
    from distributed_raytracer_tpu_torch.grad.tapegrad import (
        make_tape_camera_tracer,
        make_tape_camera_walk_tracer,
    )
    from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
    from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
    from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import build_culled_scene
    from distributed_raytracer_tpu_torch.parallel import (
        Mesh,
        make_fused_dp_render,
        make_mega_dp_render,
        make_tape_camera_dp_tracer,
        make_tape_camera_walk_dp_tracer,
    )
    from distributed_raytracer_tpu_torch.parallel.sharded import shard_size, shard_span
    from distributed_raytracer_tpu_torch.render.image import write_ppm
    from distributed_raytracer_tpu_torch.render.wavefront import render_wavefront_sum_fused

    record, dp_launches, out = {}, {}, {}
    scene5, cam5 = presets.config5()
    n_pix = cam5.num_pixels

    # --- phase 35 (a): the main path sharded (K5) ---
    bs, cs = prng.seed_pair(prng.PRNGKey(0))  # render-dist's seeds of PRNGKey(0)
    mrk.mega_render_cuda.launches = 0
    whole = mrk.render_wavefront_sum_mega(scene5, cam5, 4, bs, cs, device=dev)
    torch.cuda.synchronize()
    for world in DP_WORLDS:
        dp = make_mega_dp_render(Mesh(n_rays=world), cam5)
        mrk.mega_render_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        parts = [dp.local(scene5, bs, cs, range(4), r) for r in range(world)]
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        launches = mrk.mega_render_cuda.launches
        got = torch.cat(parts)
        s_loc = shard_size(n_pix, world)
        log(f"[dist] K5 dp world {world} (shards of {s_loc:,}, last "
            f"{shard_span(n_pix, s_loc, world - 1)[1]:,}): {launches} launches, "
            f"{wall / 4:.2f} ms/sample wall rank by rank")
        require(launches == 4 * world, f"K5 dp world {world}: {launches} launches")
        require(torch.equal(got[:n_pix], whole) and not got[n_pix:].any(),
                f"K5 dp world {world}: the shards differ from the single-device sum")
        dp_launches[f"mega_dp_render_world{world}_4spp"] = launches
    log("[dist] K5 shards at worlds 4 and 7 concatenate to render_wavefront_sum_mega's "
        "4-spp sum bit for bit")

    # a shard launch's time against the whole image's, and the short shard
    # (nonzero pix0, n_valid < n_cap) against K5's plain version
    cols, attrs, cam_row = mrk.prepare(scene5, cam5, dev)
    shard_ms = {}
    for world, rank in ((4, 0), (4, 3), (7, 6)):
        s_loc = shard_size(n_pix, world)
        pix0, n_valid = shard_span(n_pix, s_loc, rank)
        kw = dict(bounce_seed=bs, cam_seed=cs, rid_base=n_pix, pix0=pix0, n_valid=n_valid,
                  n_cap=s_loc, w=cam5.image_width, max_depth=cam5.max_depth)
        shard_ms[f"world{world}_rank{rank}"] = cuda_ms(
            lambda: mrk.mega_render_cuda(cols, attrs, cam_row, **kw), 5)
        if (world, rank) == (7, 6):
            k, kb = mrk.mega_render_cuda(cols, attrs, cam_row, **kw)
            p, pb = mrk.mega_render_plain(cols, attrs, cam_row, **kw)
            require(torch.equal(k, p) and int(kb) == int(pb),
                    "K5 on the short shard (world 7, rank 6) differs from its plain version")
            log(f"[dist] K5 on the short shard (pix0 {pix0:,}, n_valid {n_valid:,} < n_cap "
                f"{s_loc:,}, sample 1) == plain bit for bit, bounces {int(kb):,}")
    log(f"[time] K5 per shard launch (ms): {shard_ms}; whole image {k5_ms:.3f} ms")
    record["k5_shard_ms"] = shard_ms

    # render through the CLI in this process, for its wall beside render-dist's
    t0 = time.time()
    cli.main(["render", "--config", "config5", "--spp", "4", "--batch", "3", "--out",
              str(ROOT / "build" / "smoke_render4.ppm")])
    torch.cuda.synchronize()
    render_wall = (time.time() - t0) * 1e3
    # render-dist through the CLI, world size 1 on NCCL, in this process
    out_dist = ROOT / "build" / "smoke_dist.ppm"
    ref_ppm = ROOT / "build" / "smoke_dist_ref.ppm"
    write_ppm(str(ref_ppm), (whole.cpu().numpy() / 4).reshape(cam5.image_height,
                                                               cam5.image_width, 3))
    mrk.mega_render_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(["render-dist", "--config", "config5", "--spp", "4", "--batch", "3", "--engine",
              "mega", "--coordinator", f"tcp://localhost:{free_port()}", "--num-processes",
              "1", "--process-id", "0", "--out", str(out_dist)])
    torch.cuda.synchronize()
    dist_wall = (time.time() - t0) * 1e3
    launches = mrk.mega_render_cuda.launches
    require(launches == 4, f"render-dist launched K5 {launches} times, not 4")
    require(out_dist.read_bytes() == ref_ppm.read_bytes(),
            "render-dist's image differs from the single-device sum's")
    dp_launches["render_dist_world1_4spp"] = launches
    record["render_dist_ms_per_sample"] = dist_wall / 4
    record["render_cli_ms_per_sample"] = render_wall / 4
    log(f"[dist] render-dist world 1 (NCCL) config5 4 spp, batches 3+1: PPM == the single-"
        f"device sum's byte for byte; {launches} K5 launches; {dist_wall / 4:.2f} ms/sample "
        f"wall, set-up included (render through the CLI in this process "
        f"{render_wall / 4:.2f}; render_progressive's loop {main_ms_per_sample:.2f})")
    out["mega_render"] = dp_launches

    # --- phase 36 (b): training sharded (K6, K8; K9 record, K8) ---
    def dp_step(label, single, dp, scene, world, n, counters):
        target = torch.zeros(n, 3, device=dev)
        p = {k: v.to(dev).clone().requires_grad_() for k, v in scene.diff_params().items()}
        want = single(scene.with_diff_params(p), torch.arange(n))
        image_loss(want, target).backward()
        g_want = {k: v.grad for k, v in p.items()}
        q = {k: v.to(dev).clone().requires_grad_() for k, v in scene.diff_params().items()}
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        parts = [dp.local(scene.with_diff_params(q), r) for r in range(world)]
        loss = sum((x ** 2).sum() for x in parts) / (3.0 * n)
        loss.backward()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        launches = [c.launches for c in counters]
        got = torch.cat(parts).detach()
        require(launches == [world] * len(counters), f"{label}: launches {launches}")
        require(torch.equal(got[:n], want.detach()) and not got[n:].any(),
                f"{label}: the shards' colors differ from the single-device tracer's")
        worst = grad_band(label, {k: v.grad for k, v in q.items()}, g_want, TRAIN_GRAD_BAND)
        log(f"[dist] {label}: colors == the single-device tracer's bit for bit, {launches} "
            f"launches, {wall:.1f} ms wall for the {world} ranks in turn")
        return dict(launches=launches, wall_ms=wall, grad_err=worst)

    for world in DP_WORLDS:
        single = make_tape_camera_tracer(cam_main, BOUNCE_SEED, CAM_SEED, iota_pix=True)
        dp = make_tape_camera_dp_tracer(Mesh(n_rays=world), cam_main, BOUNCE_SEED, CAM_SEED)
        r = dp_step(f"camera dp world {world} (final 1200x675 depth 50)", single, dp, final,
                    world, cam_main.num_pixels,
                    [mk.mega_forward_camera_cuda, wbk.mega_walk_backward_cuda])
        record[f"camera_dp_world{world}"] = r
    out["mega_forward"] = out["mega_walk_bwd"] = {
        f"camera_dp_step_world{w}": w for w in DP_WORLDS}
    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    cam_big = walk_camera(presets, 1024)
    single = make_tape_camera_walk_tracer(cam_big, BOUNCE_SEED, CAM_SEED, field, chunk=WALK_CHUNK)
    dp = make_tape_camera_walk_dp_tracer(Mesh(n_rays=4), cam_big, BOUNCE_SEED, CAM_SEED, field,
                                         chunk=WALK_CHUNK)
    record["walk_dp_world4"] = dp_step(
        "walk dp world 4 (field 1024x576 depth 8)", single, dp, field, 4, cam_big.num_pixels,
        [mwk.mega_walk_forward_camera_cuda, wbk.mega_walk_backward_cuda])
    out["mega_walk_record"] = out["mega_walk_bwd_global"] = {"walk_dp_step_world4": 4}

    # --- phase 37 (c): the fused engine sharded (K10 dense, K14 culled), 1 spp ---
    key = prng.PRNGKey(0)
    culled = build_culled_scene(final, chunk=FUSED_CHUNK)
    for name, counter, scene, cul in (("fused_bounce", bk.fused_bounce_cuda, final, None),
                                      ("culled_fused_bounce", cb.culled_fused_bounce_cuda,
                                       culled.scene, culled)):
        dp = make_fused_dp_render(Mesh(n_rays=4), cam_main, culled=cul)
        counter.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        parts = [dp.local(scene, key, 1, r) for r in range(4)]
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        launches = counter.launches
        s_loc = shard_size(n_pix, 4)
        ids = torch.arange(n_pix, device=dev)
        for r in range(4):
            want = render_wavefront_sum_fused(
                scene, cam_main, 1, *prng.seed_pair(prng.fold_in(key, r)),
                pool_size=min(16384, s_loc), pixel_ids=ids[r * s_loc:(r + 1) * s_loc],
                culled=cul)
            require(torch.equal(parts[r], want), f"fused dp ({name}) rank {r} differs from the "
                    "single-device run at its fold_in seeds")
        img = torch.cat(parts)
        require(bool(torch.isfinite(img).all()) and launches >= 4, f"fused dp ({name}): "
                f"{launches} launches")
        log(f"[dist] fused dp world 4 ({name}, final 1200x675 depth 50, 1 spp): each shard == "
            f"the single-device run at fold_in(key, rank)'s seeds bit for bit; {launches} "
            f"launches, {wall:.0f} ms wall for the 4 ranks in turn")
        record[f"fused_dp_{name}"] = dict(launches=launches, wall_ms=wall)
        out[name] = {"fused_dp_world4_1spp": launches}

    # --- phase 38 (d): scene-sharded, 2 x 2 gloo processes on this card (K11) ---
    init = ROOT / "build" / "smoke_gloo_init"
    outdir = ROOT / "build" / "smoke_gloo"
    outdir.mkdir(parents=True, exist_ok=True)
    for f in [init, *outdir.glob("*.json")]:
        if f.exists():
            f.unlink()
    world = SHARD_RAYS * SHARD_SCENE
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--scene-shard-worker",
                               str(r), "--worker-init", str(init), "--worker-out", str(outdir)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    results = []
    try:
        for pr in procs:
            results.append(pr.communicate(timeout=WORKER_TIMEOUT_S))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, (so, se)) in enumerate(zip(procs, results)):
        for line in so.strip().splitlines():
            log(f"[shard {r}] {line}")
        require(pr.returncode == 0, f"scene-sharded worker {r} exited {pr.returncode}: "
                f"{se[-3000:]}")
    ranks = [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(world)]
    log(f"[dist] scene-sharded 2 x 2 on gloo: {time.time() - t0:.1f} s for the 4 workers")
    k11_launches = [x["k11_launches_render"] for x in ranks]
    require(all(v >= 1 for v in k11_launches), f"the scene-sharded render skipped K11: "
            f"{k11_launches}")
    record["scene_sharded"] = ranks
    out["closest_hit"] = {"scene_sharded_render_per_rank": k11_launches}

    # --- phase 39 (e): scene files: export-scene, then render --scene ---
    scene_file = ROOT / "build" / "smoke_scene5.json"
    cli.main(["export-scene", "--config", "config5", str(scene_file)])
    out_scene = ROOT / "build" / "smoke_scene.ppm"
    mrk.mega_render_cuda.launches = 0
    cli.main(["render", "--scene", str(scene_file), "--spp", "2", "--out", str(out_scene)])
    require(mrk.mega_render_cuda.launches >= 1, "render --scene did not launch K5")
    require(out_scene.read_bytes() == (ROOT / "build" / "smoke.ppm").read_bytes(),
            "render --scene of the exported config5 differs from the preset's render")
    log("[dist] export-scene config5 (JSON, padding dropped), then render --scene: the PPM "
        "equals phase 4's render of the preset byte for byte")
    return dict(dp_launches=out, record=record)


class RecordFill:
    """Wraps native.accumulate inside render/progressive.py for one run:
    keeps each fill chunk's pixel ids and colors, in order."""

    def __init__(self):
        from distributed_raytracer_tpu_torch.render import progressive

        self.native, self.chunks = progressive.native, []

    def __enter__(self):
        self.real = self.native.accumulate
        self.native.accumulate = self
        return self

    def __exit__(self, *exc):
        self.native.accumulate = self.real

    def __call__(self, raw, count, colors, ids):
        self.chunks.append((np.array(ids), np.array(colors)))
        self.real(raw, count, colors, ids)


def cli_run(args, timeout=600):
    """The port's CLI in a child process; returns the finished process."""
    return subprocess.run([sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def last_json(text: str) -> dict:
    """The last line of text that is a JSON object."""
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    require(lines, f"no JSON line in: {text[-2000:]}")
    return json.loads(lines[-1])


def check_fill_cli_path(dev, presets, final, cam_main) -> dict:
    """Phases 40-44: the last modules of the port on the card, at the main
    path (the final scene padded to 512, 1200x675 depth 50).  (40)
    render_progressive(fill="shuffled") on the mega engine: 50 fill chunks
    through K10 at a pool of 2,048, each pixel filled once, monotone
    snapshots, three chunks held against the plain bounce bit for bit,
    samples 1-3 equal K5's sum at batch_seeds(0, 1).  (41) checkpoint_every,
    the final save, a crash after a save resumed bit for bit, and the JAX
    package's committed mega checkpoint resumed from 500 to 504 spp.  (42)
    the CLI: --fill shuffled --snapshot-every 1 --job with auto engine (the
    job record, the metrics line, the PPM equal to (40)'s image), --display
    over loopback, --sanitize.  (43) supervise: --chaos crash:2, and hang:2
    with a stall timeout, each equal to a straight run.  (44) timed_best
    beside cuda_ms on K5's 4-spp render."""
    import shutil
    import signal
    import urllib.request

    from distributed_raytracer_tpu_torch import native
    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
    from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
    from distributed_raytracer_tpu_torch.render import progressive, wavefront
    from distributed_raytracer_tpu_torch.render.display import _bmp_from_argb
    from distributed_raytracer_tpu_torch.render.image import read_ppm, to_bytes, write_ppm
    from distributed_raytracer_tpu_torch.render.progressive import AccumState, render_progressive
    from distributed_raytracer_tpu_torch.utils.config import RenderJobConfig
    from distributed_raytracer_tpu_torch.utils.metrics import timed_best
    from distributed_raytracer_tpu_torch.utils.sanitize import FloatSanitizerError, checked

    record, launches = {}, {}
    n = cam_main.num_pixels
    build = ROOT / "build"
    build.mkdir(exist_ok=True)

    # --- phase 40: the shuffled fill on the mega engine ---
    snaps, done_at = [], {}

    def fill_cb(img):  # the pixels filled so far
        snaps.append(int((img.reshape(-1, 3).sum(-1) != 0).sum()))

    def progress(state):
        done_at[state.samples_done] = time.time()

    bk.fused_bounce_cuda.launches = 0
    mrk.mega_render_cuda.launches = 0
    with EngineBounces("fused_bounce", dev) as rec, RecordFill() as fill:
        torch.cuda.synchronize()
        t0 = time.time()
        state = render_progressive(final, cam_main, seed=0, spp=4, batch=3, fill="shuffled",
                                   fill_chunk=16384, engine="mega", fill_cb=fill_cb,
                                   progress_cb=progress)
        torch.cuda.synchronize()
        wall = time.time() - t0
    k10_fill, k5_after = bk.fused_bounce_cuda.launches, mrk.mega_render_cuda.launches
    fill_wall = done_at[1] - t0
    arrays = bk.fused_scene_arrays(final.to(dev))
    k10 = lambda *a: bk.fused_bounce_cuda(*a[:4], arrays, *a[4:])  # noqa: E731
    # the fill's launches replayed in groups of FILL_REPLAY_GROUP, each
    # group behind its own sleep: thousands of launches in one group
    # fill the launch queue, and the host's enqueue then counts
    k10_ms = sum(kernel_ms(lambda g=rec.inputs[i:i + FILL_REPLAY_GROUP]: [k10(*a) for a in g],
                           1) for i in range(0, len(rec.inputs), FILL_REPLAY_GROUP))
    k10_one_group = rec.replay_ms(k10)
    n_chunks = -(-n // 16384)
    require(len(fill.chunks) == n_chunks == len(snaps), f"{len(fill.chunks)} fill chunks, "
            f"{len(snaps)} snapshots, want {n_chunks}")
    count = np.bincount(np.concatenate([ids for ids, _ in fill.chunks]), minlength=n)
    require(count.shape == (n,) and (count == 1).all(), "the fill did not fill each pixel once")
    require(snaps == sorted(snaps) and snaps[0] < snaps[-1],
            "the fill's snapshots do not fill in monotonically")
    require(k10_fill == len(rec.inputs) and k10_fill >= n_chunks,
            f"the fill launched K10 {k10_fill} times ({len(rec.inputs)} bounces)")
    require(k5_after == 3, f"samples 1-3 launched K5 {k5_after} times, not 3")
    log(f"[fill] render_progressive(fill=shuffled, engine=mega) final 1200x675 depth 50, spp 4 "
        f"batch 3: {n_chunks} chunks of 16,384 through K10 (pool 2,048), {k10_fill} K10 "
        f"launches, fill {fill_wall * 1e3:.1f} ms of wall, K10 {k10_ms:.1f} ms of card time "
        f"(replayed in groups of {FILL_REPLAY_GROUP}; {k10_ms / (fill_wall * 1e3):.2%} of the "
        f"fill, {k10_ms / k10_fill:.4f} ms a launch; {k10_one_group:.1f} ms replayed as one "
        f"group), then {k5_after} K5 "
        f"launches; whole run {wall * 1e3:.1f} ms; snapshots filled {snaps[0]:,} .. "
        f"{snaps[-1]:,} pixels")
    del rec
    # three chunks against the plain bounce, at the same ids and seeds
    key = prng.fold_in(prng.PRNGKey(0), progressive.FILL_FOLD)
    perm = native.shuffled_indices(n, int(prng.randint(key, (), 0, prng.SEED_MAX)))
    real = wavefront.fused_bounce
    wavefront.fused_bounce = bk.fused_bounce_plain
    try:
        for c in range(3):
            ids, got = fill.chunks[c]
            require(np.array_equal(ids, perm[c * 16384:(c + 1) * 16384]),
                    f"fill chunk {c} is not the permutation's")
            t1 = time.time()
            want = wavefront.render_wavefront_sum_fused(
                final, cam_main, 1, *prng.seed_pair(prng.fold_in(key, c * 16384)),
                pool_size=2048, pixel_ids=torch.as_tensor(ids), device=dev).cpu().numpy()
            log(f"[fill] chunk {c}: K10 == plain bounce bit for bit "
                f"{np.array_equal(got, want)} (max abs err {float(np.abs(got - want).max()):.3e}"
                f"; plain {time.time() - t1:.1f} s)")
            require(np.array_equal(got, want), f"fill chunk {c}: K10 differs from plain")
    finally:
        wavefront.fused_bounce = real
    raw = np.zeros((n, 3), np.float32)
    cnt = np.zeros(n, np.int32)
    for ids, colors in fill.chunks:
        native.accumulate(raw, cnt, colors, ids)
    tail = mrk.render_wavefront_sum_mega(final, cam_main, 3, *progressive.batch_seeds(0, 1))
    require(np.array_equal(state.raw_sum, raw + tail.cpu().numpy()),
            "samples 1-3 after the fill differ from K5 at batch_seeds(0, 1)")
    img = state.mean_image()
    require(np.isfinite(img).all() and img[0, 600, 2] > img[0, 600, 0],
            "the filled image is not finite with a bluish sky")
    log("[fill] samples 1-3 == render_wavefront_sum_mega at batch_seeds(0, 1) bit for bit")
    launches["fill"] = dict(fused_bounce=k10_fill, mega_render=k5_after)
    record["fill"] = dict(chunks=n_chunks, k10_launches=k10_fill, fill_ms=fill_wall * 1e3,
                          k10_ms=k10_ms, k10_one_group_ms=k10_one_group,
                          k10_share=k10_ms / (fill_wall * 1e3),
                          k5_launches=k5_after, wall_ms=wall * 1e3)
    del fill

    # --- phase 41: checkpoint cadence, a crash after a save, the JAX mega checkpoint ---
    ckpt = build / "smoke_cadence.ckpt"
    ckpt.unlink(missing_ok=True)
    saves = []
    real_save = AccumState.save

    def save(self, path):
        saves.append(self.samples_done)
        real_save(self, path)

    class Crash(Exception):
        pass

    def crash_at_3(st):
        if st.samples_done == 3:
            raise Crash()

    AccumState.save = save
    try:
        kw = dict(seed=7, spp=5, batch=1, engine="mega")
        whole = render_progressive(final, cam_main, **kw)
        try:
            render_progressive(final, cam_main, checkpoint_path=str(ckpt), checkpoint_every=2,
                               progress_cb=crash_at_3, **kw)
            require(False, "the crash was not raised")
        except Crash:
            pass
        require(saves == [2], f"saves before the crash at sample 3: {saves}")
        resumed = render_progressive(final, cam_main, checkpoint_path=str(ckpt),
                                     checkpoint_every=2, **kw)
    finally:
        AccumState.save = real_save
    require(saves == [2, 4, 5], f"saves {saves}, want [2, 4, 5]: every second batch, then "
            f"the final save")
    require(np.array_equal(resumed.raw_sum, whole.raw_sum),
            "the resume after a crash is not bit-identical")
    log(f"[ckpt] checkpoint_every=2 saves at {saves} (the last the final save); crashed after "
        "sample 3, resumed from 2 to 5: equal to the uninterrupted render bit for bit")
    jax_ckpt = build / "smoke_config4_500spp_mega.ckpt"
    shutil.copyfile(ROOT / "artifacts" / "config4_500spp_mega.ckpt", jax_ckpt)
    old = AccumState.load(str(jax_ckpt))
    s4, c4 = presets.config4()
    mrk.mega_render_cuda.launches = 0
    t1 = time.time()
    st = render_progressive(s4, c4, seed=0, spp=504, batch=50, engine="mega",
                            checkpoint_path=str(jax_ckpt))
    resume_ms = (time.time() - t1) * 1e3
    k5_resume = mrk.mega_render_cuda.launches
    delta = mrk.render_wavefront_sum_mega(s4, c4, 4, *progressive.batch_seeds(0, 500))
    require(st.samples_done == 504 and k5_resume == 4,
            f"resume reached {st.samples_done} spp with {k5_resume} K5 launches")
    require(np.array_equal(st.raw_sum, old.raw_sum + delta.cpu().numpy()),
            "the resumed JAX checkpoint is not its sum plus K5's 4 spp at batch_seeds(0, 500)")
    log(f"[ckpt] artifacts/config4_500spp_mega.ckpt ({old.engine}, batch {old.batch}, "
        f"{old.samples_done} spp) resumed to 504 spp in {resume_ms:.1f} ms with {k5_resume} K5 "
        f"launches: old sum + K5 at batch_seeds(0, 500) bit for bit")
    launches["resume_504"] = dict(mega_render=k5_resume)
    record["resume_ms"] = resume_ms

    # --- phase 42: the CLI (--job, --fill, --snapshot-every, auto engine; display; sanitize) ---
    job_file, out_ppm, cli_ckpt = (build / "smoke_job.json", build / "smoke_fill.ppm",
                                   build / "smoke_fill.ckpt")
    for f in (out_ppm, cli_ckpt):
        f.unlink(missing_ok=True)
    job_file.write_text(RenderJobConfig(preset="config5", seed=0, spp=4, batch=3,
                                        output=str(out_ppm), fill="shuffled").to_json())
    t1 = time.time()
    r = cli_run(["render", "--job", str(job_file), "--snapshot-every", "1", "--checkpoint",
                 str(cli_ckpt)])
    cli_s = time.time() - t1
    require(r.returncode == 0, r.stderr[-4000:])
    job = RenderJobConfig.from_json(Path(str(cli_ckpt) + ".json").read_text())
    require((job.preset, job.engine, job.fill, job.spp, job.batch, job.seed) ==
            ("config5", "mega", "shuffled", 4, 3, 0), f"job record {job}")
    metrics = last_json(r.stderr)
    require(metrics["samples_done"] == 4 and metrics["rays_traced"] == 4 * n
            and set(metrics) == {"rays_traced", "samples_done", "rays_per_sec", "phases"},
            f"metrics line {metrics}")
    want_bytes = to_bytes(img)
    require(np.array_equal(read_ppm(str(out_ppm)), want_bytes),
            "the CLI's PPM differs from render_progressive's mean image")
    log(f"[cli] render --job (config5, spp 4, batch 3, fill shuffled) --snapshot-every 1 with "
        f"the auto engine: exit 0 in {cli_s:.1f} s, job record {job.engine}/{job.fill}, "
        f"metrics {json.dumps(metrics)}; the PPM equals phase 40's image byte for byte")
    record["cli_fill_s"] = cli_s

    disp_ppm = build / "smoke_display.ppm"
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", "render", "--config",
         "config5", "--spp", "2", "--display", "--display-port", "0", "--display-linger",
         "--out", str(disp_ppm)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    timer = threading.Timer(300, proc.kill)
    timer.start()
    try:
        url, lines = None, []
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"final frame at (http://\S+/)", line)
            if m:
                url = m.group(1)
                break
        require(url is not None, "".join(lines)[-3000:])
        with urllib.request.urlopen(url + "stats.json", timeout=30) as resp:
            stats = json.loads(resp.read())
        with urllib.request.urlopen(url + "frame.bmp", timeout=30) as resp:
            bmp = resp.read()
        proc.send_signal(signal.SIGINT)
        rest = proc.communicate(timeout=60)[1]
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    require(proc.returncode == 0, "".join(lines)[-2000:] + rest[-2000:])
    two = render_progressive(final, cam_main, seed=0, spp=2, batch=16, engine="mega")
    want_bmp = _bmp_from_argb(native.tonemap_pack(two.mean_image()), 1200, 675)
    require(stats["spp_done"] == 2 and stats["width"] == 1200 and stats["frames"] >= 2,
            f"/stats.json {stats}")
    require(bmp == want_bmp, "/frame.bmp differs from the tonemapped 2-spp image")
    log(f"[cli] render --display --display-port 0 --display-linger: {url} served /stats.json "
        f"{stats} and /frame.bmp ({len(bmp):,} bytes) equal to the 2-spp image's BMP; "
        f"SIGINT ended it with exit 0")

    with checked_raises(FloatSanitizerError):
        x = torch.zeros(4, 3, device=dev, requires_grad=True)
        checked(lambda v: torch.autograd.grad(
            torch.where(torch.sqrt((v * v).sum(-1)) > 0, torch.sqrt((v * v).sum(-1)),
                        0.0).sum(), v))(x)
    san_ppm = build / "smoke_sanitize.ppm"
    t1 = time.time()
    r = cli_run(["render", "--config", "config5", "--spp", "2", "--sanitize", "--out",
                 str(san_ppm)])
    require(r.returncode == 0 and "[sanitize] clean" in r.stderr, r.stderr[-4000:])
    require(san_ppm.read_bytes() == disp_ppm.read_bytes(),
            "the sanitized render differs from the plain 2-spp render")
    log(f"[cli] the sanitizer flags the single-where gradient on the card (its backward ops "
        f"checked); render --sanitize: pre-flight clean on the card, the 2-spp render under "
        f"nan_debug equals the render without it byte for byte ({time.time() - t1:.1f} s)")

    # --- phase 43: supervise (crash, then hang with a stall timeout) ---
    write_ppm(str(build / "smoke_straight.ppm"),
              render_progressive(final, cam_main, seed=0, spp=4, batch=1,
                                 engine="mega").mean_image())
    straight = (build / "smoke_straight.ppm").read_bytes()
    for mode, extra in (("crash", []), ("hang", ["--stall-timeout", "20"])):
        ck, beat, out = (build / f"smoke_sup_{mode}.ckpt", build / f"smoke_sup_{mode}.beat",
                         build / f"smoke_sup_{mode}.ppm")
        for f in (ck, Path(str(ck) + ".chaos"), beat, out):
            f.unlink(missing_ok=True)
        t1 = time.time()
        r = cli_run(["supervise", "--max-restarts", "2", *extra, "--", "render", "--config",
                     "config5", "--spp", "4", "--batch", "1", "--checkpoint", str(ck),
                     "--heartbeat", str(beat), "--chaos", f"{mode}:2", "--out", str(out)])
        took = time.time() - t1
        event = "exit:13" if mode == "crash" else "stall"
        require(r.returncode == 0 and "after 1 restart" in r.stderr and event in r.stderr,
                r.stderr[-4000:])
        require(out.read_bytes() == straight,
                f"the supervised {mode} render differs from the straight run")
        killed = re.findall(r"killing pid \d+", r.stderr)
        log(f"[supervise] --chaos {mode}:2: restarted once ({event}"
            f"{', ' + killed[0] if killed else ''}), the PPM equals the straight run byte for "
            f"byte; {took:.1f} s")
        record[f"supervise_{mode}_s"] = took

    # --- phase 44: timed_best beside cuda_ms on K5's 4-spp render ---
    seeds = progressive.batch_seeds(0, 0)

    def k5_4spp():
        return mrk.render_wavefront_sum_mega(final, cam_main, 4, *seeds, device=dev)

    best_s = timed_best(k5_4spp, iters=3, reps=3)
    ev_ms = cuda_ms(k5_4spp, 5)
    log(f"[time] K5 4 spp through render_wavefront_sum_mega: timed_best {best_s * 1e3:.3f} ms "
        f"(host clock, the card waited for), cuda_ms {ev_ms:.3f} ms (CUDA events)")
    record["timed_best_ms"], record["cuda_ms"] = best_s * 1e3, ev_ms
    return dict(launches=launches, record=record)


@contextlib.contextmanager
def checked_raises(exc):
    """The block must raise exc."""
    try:
        yield
    except exc:
        return
    raise SmokeFailure(f"{exc.__name__} was not raised")


def scene_shard_worker(rank: int, init: str, outdir: str) -> int:
    """One rank of phase 38: a 2 x 2 (rays x scene) mesh on gloo over this
    card.  Probes which gloo collectives take CUDA tensors, then holds
    closest_hit_sharded (K11 on the rank's block) to the dense K11 hit on
    the padded unsplit scene, t and idx bit for bit, on a pool batch of
    final-scene camera rays and on random rays over the 8,192-sphere
    field; then one sample of make_scene_sharded_render at 1200x675 depth
    50 against the replicated trace of the rank's rays on the same keys
    (pixel band 1e-4), every K11 launch at the shard's shape held against
    its plain version.  Writes its numbers to outdir/rank{rank}.json."""
    import torch.distributed as tdist

    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row, generate_rays
    from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
    from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import camera_rays_host
    from distributed_raytracer_tpu_torch.ops.trace import trace_rays_fast
    from distributed_raytracer_tpu_torch.parallel import make_mesh, multihost, shard_scene
    from distributed_raytracer_tpu_torch.parallel.scene_sharded import (
        closest_hit_sharded,
        make_scene_sharded_render,
        scene_block,
    )

    dev = torch.device("cuda")
    world = SHARD_RAYS * SHARD_SCENE
    multihost.initialize(f"file://{init}", world, rank, device=dev, backend="gloo")
    res = {"rank": rank}
    try:
        # which collectives the installed gloo runs on CUDA tensors
        probe = {}
        x = torch.full((4,), float(rank + 1), device=dev)
        for name, fn in (("all_reduce", lambda: tdist.all_reduce(x.clone())),
                         ("broadcast", lambda: tdist.broadcast(x.clone(), src=0)),
                         ("all_gather", lambda: tdist.all_gather(
                             [torch.empty_like(x) for _ in range(world)], x))):
            try:
                fn()
                probe[name] = "ok"
            except Exception as e:  # a missing collective is the answer the probe records
                probe[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        torch.cuda.synchronize()
        res["gloo_cuda_collectives"] = probe
        print(f"gloo collectives on CUDA tensors: {probe}", flush=True)
        require(probe["all_reduce"] == "ok", f"gloo cannot all_reduce CUDA tensors: {probe}")

        mesh = make_mesh(n_rays=SHARD_RAYS, n_scene=SHARD_SCENE)
        checks = {"launches": 0}

        def checked_k11(o, d, scene):
            """K11 on the block (closest_hit_pallas), each launch held
            against its plain version on the same inputs, bit for bit."""
            hit = ik.closest_hit_pallas(o, d, scene)
            t, idx = ik.closest_hit_plain(o.contiguous(), d.contiguous(),
                                          ik.sphere_pack(scene.centers, scene.radii))
            require(torch.equal(hit.t, t) and torch.equal(hit.idx, idx),
                    f"K11 at shard shape {tuple(o.shape)} x {scene.num_spheres} differs from "
                    "plain")
            checks["launches"] += 1
            return hit

        final = presets.rtiow_final_scene(seed=0, pad_to=512)
        cam = presets.final_scene_camera(1200)
        field = presets.random_sphere_field(8192, seed=5, extent=30.0)
        g = torch.Generator().manual_seed(11)
        pix = torch.randperm(cam.num_pixels, generator=g)[:SHARD_POOL].to(dev)
        o_f, d_f = camera_rays_host(camera_scalar_row(cam).to(dev), pix, pix, CAM_SEED,
                                    cam.image_width)
        o_r = torch.stack([torch.rand(SHARD_POOL, generator=g) * 60 - 30,
                           torch.rand(SHARD_POOL, generator=g) * 4 + 1,
                           torch.rand(SHARD_POOL, generator=g) * 60 - 30], -1).to(dev)
        d_r = torch.randn(SHARD_POOL, 3, generator=g).to(dev)
        for label, scene, o, d in (("final", final, o_f, d_f), ("field", field, o_r, d_r)):
            padded = shard_scene(scene.to(dev), SHARD_SCENE)
            block = scene_block(padded, mesh)
            with torch.no_grad():
                hit = closest_hit_sharded(o.contiguous(), d.contiguous(), block, mesh,
                                          checked_k11)
                dense = ik.closest_hit_pallas(o.contiguous(), d.contiguous(), padded)
            same = (torch.equal(hit.t.view(torch.int32), dense.t.view(torch.int32))
                    and torch.equal(hit.idx, dense.idx))
            res[f"hit_{label}"] = dict(rays=SHARD_POOL, spheres=padded.num_spheres,
                                       block=block.num_spheres, hits=int(hit.hit.sum()),
                                       bit_for_bit=same)
            print(f"closest_hit_sharded on {label} ({padded.num_spheres} spheres, blocks of "
                  f"{block.num_spheres}, {SHARD_POOL:,} rays): t and idx == the dense K11 hit "
                  f"bit for bit: {same}", flush=True)
            require(same, f"closest_hit_sharded on {label} differs from the dense K11 hit")

        # one sample of the 2D render at the main path
        padded = shard_scene(final.to(dev), SHARD_SCENE)
        n = cam.num_pixels
        ids = torch.arange(n, device=dev)
        render = make_scene_sharded_render(mesh, cam, local_intersect=checked_k11)
        key = prng.PRNGKey(0)
        ik.closest_hit_cuda.launches = 0
        checks["launches"] = 0
        torch.cuda.synchronize()
        t0 = time.time()
        got = render(padded, key, [0], ids)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        res["k11_launches_render"] = ik.closest_hit_cuda.launches
        res["k11_checked"] = checks["launches"]
        res["render_wall_ms"] = wall
        require(res["k11_launches_render"] == res["k11_checked"] >= 1,
                f"K11 launches {res['k11_launches_render']} vs checked {res['k11_checked']}")
        require(got.shape == (n // SHARD_RAYS, 3) and bool(torch.isfinite(got).all()),
                "the scene-sharded render is not finite")
        if mesh.scene_index == 0:  # one rank of each row holds its rays to the reference
            s = n // SHARD_RAYS
            tids = ids[mesh.rays_index * s:(mesh.rays_index + 1) * s]
            k_cam, k_trace = prng.split(prng.fold_in(prng.fold_in(key, 0), mesh.rays_index))
            o, d = generate_rays(cam.to(dev), tids % cam.image_width, tids // cam.image_width,
                                 key=k_cam)
            want = trace_rays_fast(padded, o, d, k_trace, cam.max_depth,
                                   intersect_fn=ik.closest_hit_pallas)
            diff = (got - want).abs().max(dim=1).values
            res["render_max_err"] = float(diff.max())
            res["render_bit_for_bit_share"] = float((got == want).all(dim=1).float().mean())
            print(f"scene-sharded sample 1200x675 depth 50, rays shard {mesh.rays_index}: max "
                  f"|diff| {res['render_max_err']:.3e} vs the replicated trace, "
                  f"{res['render_bit_for_bit_share']:.4%} of pixels bit for bit; "
                  f"{res['k11_launches_render']} K11 launches each == plain; {wall:.0f} ms",
                  flush=True)
            require(res["render_max_err"] <= 1e-4, "the scene-sharded render parts from the "
                    f"replicated trace by {res['render_max_err']:.3e}")
        Path(outdir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        multihost.shutdown()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, help="write the run's numbers to this JSON file")
    # one rank of phase 38's gloo job (started by the run itself)
    ap.add_argument("--scene-shard-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.scene_shard_worker is not None:
        return scene_shard_worker(args.scene_shard_worker, args.worker_init, args.worker_out)
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.kernels import _build
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
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
    ptxas = {name: ptxas_kernels(report) for name, report in reports.items()}
    for name, entries in ptxas.items():
        for e in entries:
            log(f"[build] {name}.cu {e['kernel']}: {e['registers']} registers, spill stores "
                f"{e['spill_stores']} B, spill loads {e['spill_loads']} B, {e['smem']} B smem")
    dev = torch.device("cuda")
    # the persistent kernels' grids, by (name, source, mode): 256 threads a
    # block for K5, K6 and K9, 128 for the reverse walks K8 and K7
    grids = {name: _build.occupancy_grid(src, f"{src}_blocks_per_sm", dev, *mode)
             for name, src, mode in (
                 ("mega_render", "mega_render", ()), ("mega_forward", "mega_forward", (0,)),
                 ("mega_forward_ray", "mega_forward", (1,)), ("mega_walk", "mega_walk", (0,)),
                 ("mega_walk_record", "mega_walk", (1,)),
                 ("mega_walk_bwd", "mega_walk_bwd", (0,)),
                 ("mega_walk_bwd_rays", "mega_walk_bwd", (1,)), ("mega_bwd", "mega_bwd", (1,)))}
    log(f"[build] persistent grids (SMs x blocks per SM): {grids}")

    def both(scene, cam, sample=0, bounce_seed=BOUNCE_SEED, cam_seed=CAM_SEED, grid=None):
        cols, attrs, cam_row = mrk.prepare(scene, cam, dev)
        kw = dict(bounce_seed=bounce_seed, cam_seed=cam_seed,
                  rid_base=sample * cam.num_pixels, pix0=0, n_valid=cam.num_pixels,
                  n_cap=cam.num_pixels, w=cam.image_width, max_depth=cam.max_depth)
        k_col, k_b, k_s = mrk.mega_render_cuda(cols, attrs, cam_row, grid=grid,
                                               with_warp_steps=True, **kw)
        p_col, p_b = mrk.mega_render_plain(cols, attrs, cam_row, **kw)
        torch.cuda.synchronize()
        return k_col, int(k_b), int(k_s), p_col, int(p_b), (cols, attrs, cam_row, kw)

    def same_render(label, k, kb, p, pb):
        """K5 and its plain version gave the same image and bounce count,
        bit for bit."""
        st = compare(label, k, p)
        log(f"[check] {label}: bounces kernel {kb} plain {pb}")
        require(torch.equal(k, p) and kb == pb, f"{label}: K5 differs from plain")
        return st

    # --- phase 2: kernel vs plain version on the card, bit for bit ---
    c2_scene, c2_cam = presets.config2()
    k, kb, _, p, pb, _ = both(c2_scene, c2_cam)
    same_render("config2 400x225 depth 50", k, kb, p, pb)
    require(bool(torch.isfinite(k).all()), "config2 kernel image is not finite")

    final = presets.rtiow_final_scene(seed=0, pad_to=512)
    cam_main = presets.final_scene_camera(1200)
    for depth in (1, 8):
        k, kb, _, p, pb, _ = both(final, cam_main.replace(max_depth=depth))
        same_render(f"final 1200x675 depth {depth}", k, kb, p, pb)

    # the main-path shape: depth 50, at the occupancy grid and at one block
    # (one pool refilled some 9,000 times)
    k, kb, ks, p, pb, (cols, attrs, cam_row, kw) = both(final, cam_main)
    st_main = same_render("final 1200x675 depth 50", k, kb, p, pb)
    k5_lane = mk.lane_use(kb, ks)
    k1, k1b, k1s, _, _, _ = both(final, cam_main, grid=1)
    same_render("final 1200x675 depth 50, one block", k1, k1b, p, pb)
    log(f"[lane] K5 final 1200x675 depth 50: {kb:,} bounces in {ks:,} warp steps, lane use "
        f"{k5_lane:.4f} (grid {grids['mega_render']}); one block {mk.lane_use(k1b, k1s):.4f}")
    del k1, p

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
    peak = fp32_peak_flops()
    grad = check_gradient_path(dev, presets, final, cam_main, k, peak)
    # --- phases 10-14: the walk engine past 512 spheres (K9, K8 past 512) ---
    walk = check_walk_path(dev, presets, final, cam_main, k, kb, ms, peak)
    # --- phases 15-18: gradients through rays and the camera pose (K6 ray mode, K7,
    # K8 with ray grads) ---
    rays = check_ray_pose_path(dev, final, cam_main)
    # --- phases 19-23: the fused wavefront engine (K10, K14) ---
    fused = check_fused_path(dev, presets, final, cam_main, k, peak)
    # --- phases 24-29: the reference bounce, its scan and wavefront engines
    # (K11, K12, K13) ---
    ref = check_reference_path(dev, presets, final, cam_main, peak)
    # --- phases 30-34: the training paths of the host-loop tape tracer, the
    # path-replay tracer and diff_render (K10, K11, K12, K13) ---
    train = check_training_paths(dev, presets, final, cam_main)
    # --- phases 35-39: the distributed layer (K5, K6, K8, K9, K10, K14, K11 on shards)
    # and scene files ---
    dist = check_distributed_path(dev, presets, final, cam_main, ms, wall * 1e3 / 4)
    # --- phases 40-44: the shuffled fill (K10), checkpoint cadence and the JAX
    # checkpoint's resume (K5), the CLI, display, sanitizer and supervisor ---
    fill = check_fill_cli_path(dev, presets, final, cam_main)

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
        library_note=NO_LIBRARY["mega_render"], lane_use=k5_lane,
        dp_launches=dist["dp_launches"]["mega_render"],
        # samples 1-3 after the shuffled fill (phase 40), the JAX checkpoint's
        # resume from 500 to 504 spp (phase 41)
        fill_launches=dict(after_fill=fill["launches"]["fill"]["mega_render"],
                           resume_504=fill["launches"]["resume_504"]["mega_render"]),
        # the same rays as K6's at the main path (sample 0), so the same lengths
        lane_use_static=grad["mega_forward"]["lane_use_static"],
    )]
    for name, g in [(n, grad[n]) for n in ("mega_forward", "mega_walk_bwd")] + [
            (n, walk[n]) for n in ("mega_walk", "mega_walk_record", "mega_walk_bwd_global")] + [
            (n, rays[n]) for n in ("mega_forward_ray", "mega_bwd", "mega_walk_bwd_rays")] + [
            (n, fused[n]) for n in ("fused_bounce", "culled_fused_bounce",
                                    "culled_fused_bounce_field")] + [
            (n, ref[n]) for n in ("closest_hit", "culled_closest_hit",
                                  "culled_closest_hit_walk")]:
        src = ROW_SOURCE[name]
        ops_s = g["flops"] / peak
        bytes_s = g["bytes"] / HBM_BYTES_PER_S
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE.format(src),
            replaces=ROW_REPLACES.get(name, REPLACES[src]),
            launches=g["launches"], max_abs_err=g["max_abs_err"], ms=g["ms"],
            plain_ms=g["plain_ms"], bound_ms=max(ops_s, bytes_s) * 1e3,
            bound_by="operations" if ops_s >= bytes_s else "bytes", library_ms=None,
            library_note=NO_LIBRARY[src]))
        if name in train["training_launches"]:
            # the same kernel's launches on each training path (phases 30-34)
            kernels[-1]["training_launches"] = train["training_launches"][name]
        if name in dist["dp_launches"]:
            # its launches on the distributed paths (phases 35-38)
            kernels[-1]["dp_launches"] = dist["dp_launches"][name]
        if name in fill["launches"]["fill"]:
            # its launches in the shuffled fill of 50 chunks (phase 40)
            kernels[-1]["fill_launches"] = fill["launches"]["fill"][name]
        for key in ("max_norm_err",  # g_pm's columns span orders of magnitude
                    # the persistent kernels (K5-K9): lane use, the walk's sweep lane use,
                    # one thread per ray in static warps of 32
                    "lane_use", "sweep_lane_use", "lane_use_static",
                    # the group walk (K14, K12/K13): slot tests / slot-test lanes issued
                    "group_lane_use"):
            if key in g:
                kernels[-1][key] = g[key]
    for kd in kernels:
        lane = "".join(f", {key.replace('_', ' ')} {kd[key]:.4f}" for key in (
            "lane_use", "sweep_lane_use", "lane_use_static", "group_lane_use") if key in kd)
        log(f"[kernel] {kd['name']}: {kd['ms']:.3f} ms, bound {kd['bound_ms']:.4f} ms "
            f"({kd['bound_by']}), plain {kd['plain_ms']:.1f} ms, launches {kd['launches']}, "
            f"max_abs_err {kd['max_abs_err']:.3e}{lane}")
    if args.record:
        record = dict(card=smi, kernels=kernels, ptxas=ptxas, grids=grids,
                      mean_bounces_per_ray=kb / n_pix,
                      main_path_ms_per_sample=wall * 1e3 / 4, gradient_path=grad["record"],
                      walk_path=walk["record"], ray_pose_path=rays["record"],
                      fused_path=fused["record"], reference_path=ref["record"],
                      training_paths=train["record"], distributed_paths=dist["record"],
                      fill_cli_paths=fill["record"],
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
