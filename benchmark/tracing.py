"""The traced run: torch.profiler over the measured window, a span around
each request recorded by the benchmark (a `record_function` range, so
that spans and device activity share the profiler's clock), and the
reduction of the profiler's events to what the per-layer metrics read.

Device time is the union of the intervals in which some activity (kernel,
copy, fill) ran on the card; idle is the rest of the window, from the
first request's start to the last one's end.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "bench.request"


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:  # cut at the first '(' outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out).strip()[:120]


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: List[Tuple[int, int]], starts: List[int], s: int, e: int) -> int:
    """ns of [s, e) that the merged intervals cover."""
    total = 0
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    while i < len(merged) and merged[i][0] < e:
        a, b = merged[i]
        total += max(0, min(b, e) - max(a, s))
        i += 1
    return total


@dataclass
class TraceData:
    """What the per-layer metrics read: the request spans, the device
    activities (start ns, end ns, short name) and their union, all in the
    profiler's clock."""

    spans: List[Tuple[int, int]]
    device: List[Tuple[int, int, str]]
    busy: List[Tuple[int, int]]
    window: Tuple[int, int]
    gaps_by_host: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        starts = [s for s, _ in self.busy]
        return covered(self.busy, starts, *self.window) * 1e-9

    def kernels(self, pattern: str) -> List[float]:
        """Seconds of each device activity whose name matches pattern."""
        rx = re.compile(pattern)
        return [(e - s) * 1e-9 for s, e, n in self.device if rx.search(n)]

    def inside_spans(self, names: Optional[set] = None) -> List[Tuple[float, float]]:
        """Per span: (its seconds, seconds of device activity inside it,
        over all activity or over the activities whose name is in names)."""
        ivs = merge([(s, e) for s, e, n in self.device
                     if names is None or n.split("<")[0] in names])
        starts = [s for s, _ in ivs]
        return [((e - s) * 1e-9, covered(ivs, starts, s, e) * 1e-9) for s, e in self.spans]

    def breakdown(self) -> dict:
        ops: Dict[str, float] = {}
        for s, e, n in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s) * 1e-9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(self.gaps_by_host)}


class Window:
    """Profiler over the window when enabled; spans around requests."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def span(self):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN)

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self) -> TraceData:
        events = self.prof.profiler.kineto_results.events()
        spans, device, host = [], [], []
        for ev in events:
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if ev.name() != SPAN:  # the span's own device-side range is no activity
                    device.append((s, e, short_name(ev.name())))
            elif ev.name() == SPAN:
                spans.append((s, e))
                host.append((s, e, ev.start_thread_id(), SPAN))
            else:
                host.append((s, e, ev.start_thread_id(), ev.name()))
        spans.sort()
        window = (spans[0][0], spans[-1][1]) if spans else (0, 0)
        device = [d for d in device if d[1] > window[0] and d[0] < window[1]]
        busy = merge([(s, e) for s, e, _ in device])
        data = TraceData(spans=spans, device=device, busy=busy, window=window)
        data.gaps_by_host = _gaps_by_host(busy, window, host)
        return data


def _innermost(host, window) -> List[Tuple[int, int, str]]:
    """The requests' thread's time line as segments (start, end, name) of
    the innermost host event open in each (events on one thread nest)."""
    main = {tid for s, e, tid, n in host if n == SPAN}
    evs = sorted(((s, -e, n) for s, e, tid, n in host if tid in main), key=lambda x: x[:2])
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    t = window[0]

    def emit(a, b):
        if b > a:
            segs.append((a, b, stack[-1][1] if stack else "(outside the requests)"))

    for s, neg_e, n in evs:
        while stack and stack[-1][0] <= s:
            emit(t, stack[-1][0])
            t = max(t, stack[-1][0])
            stack.pop()
        emit(t, s)
        t = max(t, s)
        stack.append((-neg_e, n))
    while stack:
        emit(t, stack[-1][0])
        t = max(t, stack[-1][0])
        stack.pop()
    emit(t, window[1])
    return segs


def _gaps_by_host(busy, window, host) -> Dict[str, float]:
    """Seconds of device idle in the window, split by the innermost host
    event open on the requests' thread at each moment of the gap (time in
    a request's span but in no operation is the span's own: Python)."""
    gaps, t = [], window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    out: Dict[str, float] = {}
    segs = _innermost(host, window)
    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b, n = segs[j]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                out[n] = out.get(n, 0.0) + ov * 1e-9
            j += 1
    return out
