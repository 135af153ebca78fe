"""One run of one cell: read the cell's files by the names in
BENCHMARK.json, set up its driver, measure a closed loop of requests for
a fixed window, read the metrics, and decide `correct` against the plain
reference.

Everything that belongs to one configuration, traffic mix, metric or
cell is a file of its own, found by name:

  configs/<config>.json    the scene and camera, as run
  traffic/<traffic>.json   the traffic mix; its "kind" names the driver,
                           drivers/<kind>.py
  metrics/<metric>.py      read(record) -> float or None, one per metric
  limits/<cell>.json       how much the check compares, and the limit of
                           each number it compares
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark import tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_raytracer_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, config=load_json(ROOT / cfg["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"), chips=int(w["chips"]),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def driver_class(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver


def metric_reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Record:
    """What the window measured; the metric readers read it."""

    setup_s: float
    window_s: float
    times: List[float]          # seconds of each completed request, submission to result
    rays: int                   # camera rays of the completed requests
    units: Dict[str, int]       # e.g. images, samples and batches, or steps
    gaps: List[float] = field(default_factory=list)  # seconds between snapshots, if any
    trace: Optional[tracing.TraceData] = None
    port_kernels: set = field(default_factory=set)
    work_sample: Optional[Callable] = None
    _work: Optional[dict] = None

    def work(self) -> dict:
        """The reference's counts of one sample of this run's traffic
        (bounces, near tests, live spheres), worked out on first use."""
        if self._work is None:
            self._work = self.work_sample()
        return self._work


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def make_driver(cell: Cell, seed: int, device):
    return driver_class(cell.traffic["kind"])(cell.config, cell.traffic, cell.limits["check"],
                                              seed, device)


@dataclass
class Loop:
    """The closed loop of one window."""

    times: List[float] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    rays: int = 0
    window_s: float = 0.0


def closed_loop(drv, seconds: float, win: tracing.Window) -> Loop:
    """Requests one after another until `seconds` have passed; the window
    ends when the last request started in it has answered."""
    lp = Loop()
    with win:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            lp.attempted += 1
            ts = time.perf_counter()
            try:
                with win.span():
                    n = drv.request(len(lp.times))
            except Exception:  # a request that raises never answers: counted, then stop
                traceback.print_exc()
                lp.failed += 1
                break
            lp.times.append(time.perf_counter() - ts)
            lp.rays += n
        lp.window_s = time.perf_counter() - t0
    return lp


def verdict(cell: Cell, readings: dict, lp: Loop):
    """(correct, {number: {"value", "limit"}})."""
    checks = {k: {"value": readings.get(k), "limit": v} for k, v in cell.limits["limits"].items()}
    ok = bool(lp.times) and lp.failed == 0 and all(
        c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             on_window_closed: Optional[Callable] = None):
    """One run: (the result object without "device", the Record)."""
    from benchmark import port

    drv = make_driver(cell, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")
    win = tracing.Window(trace)
    lp = closed_loop(drv, seconds, win)
    if on_window_closed is not None:
        on_window_closed()
    rec = Record(setup_s=setup_s, window_s=lp.window_s,
                 times=lp.times, rays=lp.rays, units=drv.units(len(lp.times)),
                 gaps=list(getattr(drv, "gaps", [])))
    log(f"{len(lp.times)} requests in {rec.window_s:.3f} s")
    result = {"correct": False, "attempted": lp.attempted, "failed": lp.failed, "metrics": {}}
    if trace:
        rec.trace = win.reduce()
        rec.port_kernels = port.kernel_names()
        rec.work_sample = drv.work_sample
        result["breakdown"] = rec.trace.breakdown()
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"])(rec) if lp.times else None
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    drv.release()
    readings = drv.check(torch.float32) if lp.times else {}
    result["correct"], result["checks"] = verdict(cell, readings, lp)
    return result, rec
