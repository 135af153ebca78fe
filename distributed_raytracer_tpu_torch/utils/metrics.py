"""Structured metrics and phase timing (the port of distributed_raytracer_tpu/
utils/metrics.py).

RenderMetrics sums per-phase wall seconds and counts rays and prints one
JSON line with JAX's keys and rounding; profiler_trace wraps a block in
torch.profiler and writes a Chrome trace; timed_best times a callable the
way bench.py does, waiting for the card where the outputs live.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass
class RenderMetrics:
    rays_traced: int = 0
    samples_done: int = 0
    phase_seconds: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + (
                time.perf_counter() - t0)

    def add_rays(self, n: int) -> None:
        self.rays_traced += n

    @property
    def rays_per_sec(self) -> float:
        total = sum(self.phase_seconds.values())
        return self.rays_traced / total if total > 0 else 0.0

    def report(self, stream=None) -> None:
        """One JSON line: rays_traced, samples_done, rays_per_sec (0.1),
        phases (seconds, 0.001); stderr unless stream is given."""
        stream = stream if stream is not None else sys.stderr
        print(json.dumps({
            "rays_traced": self.rays_traced,
            "samples_done": self.samples_done,
            "rays_per_sec": round(self.rays_per_sec, 1),
            "phases": {k: round(v, 3) for k, v in self.phase_seconds.items()},
        }), file=stream, flush=True)


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """torch.profiler over the block, CPU and (with a card) CUDA
    activities; the Chrome trace goes to logdir/trace.json.  A no-op when
    logdir is None or empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def wait_for(out):
    """Wait for every CUDA device that holds a tensor of out (a tensor, or
    tensors in lists, tuples and dicts); nothing for CPU tensors."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return out


def timed_best(fn, *args, iters=3, reps=1, block_until_ready=None):
    """Seconds per call: the mean of iters calls, best of reps such means,
    after one warm-up call; each mean ends when block_until_ready(out)
    returns (by default, when the card holding the outputs is done)."""
    block = block_until_ready or wait_for
    block(fn(*args))  # build + warm-up
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        block(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best
