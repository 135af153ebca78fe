"""A configuration and a cell added as new files and new entries of
BENCHMARK.json alone: in a copy of the benchmark, a scene generator, a
configuration with its CPU forms, a cell and its limits are added; no
file that was there changes, and the harness finds the new scene by name,
runs a window of the new cell on the CPU and judges it correct."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROGRAM = "distributed_raytracer_tpu_torch"
CONFIG = "ring_field"
CELL = "ring_field.progressive"
RENDER_METRICS = ("render_rays_per_s", "snapshot_p95_ms", "device_idle_pct.render",
                  "host_ms_per_batch")

GENERATOR = '''"""A test scene: n small spheres jittered on a square grid over a
ground sphere, 60% Lambertian, 30% metal, 10% glass."""

from __future__ import annotations

import numpy as np

from benchmark.reference.scenes import SceneRows, seeded_rng


def make(seed: int, n: int = 300) -> dict:
    rng = seeded_rng(seed)
    s = SceneRows()
    s.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    side = int(np.ceil(np.sqrt(n)))
    for k in range(n):
        a, b = divmod(k, side)
        center = (0.5 * (a - side / 2) + 0.3 * rng.random(), 0.1,
                  0.5 * (b - side / 2) + 0.3 * rng.random())
        kind = rng.random()
        if kind < 0.6:
            s.lambertian(center, 0.1, rng.random(3))
        elif kind < 0.9:
            s.metal(center, 0.1, rng.uniform(0.5, 1.0, 3), rng.uniform(0.0, 0.5))
        else:
            s.dielectric(center, 0.1, 1.5)
    return s.arrays()
'''

CONFIG_FILE = {
    "name": CONFIG,
    "source": "https://example.org/ring_field",
    "scene": {"generator": CONFIG, "seed": 7, "n": 300},
    # 60 spheres for the run below; 600, past one dense sweep, for the walk
    "cpu_forms": {"small": {"n": 60}, "wide": {"n": 600}},
    "camera": {"image_width": 320, "aspect_ratio": 1.7777777777777777, "vfov": 40.0,
               "lookfrom": [0.0, 4.0, 9.0], "lookat": [0.0, 0.0, 0.0], "vup": [0.0, 1.0, 0.0],
               "defocus_angle": 0.0, "focus_dist": 9.0, "max_depth": 8,
               "samples_per_pixel": 32},
    "precision": "float32",
    "reduced": [],
}
LIMITS = {"check": {"images": 4, "pixels": 2048}, "limits": {"pixel_mismatch_pct": 70.0}}


def digests(top: Path) -> dict:
    return {p.relative_to(top): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(top.rglob("*")) if p.is_file()}


def add_entries(bench: dict) -> dict:
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": CONFIG, "source": "https://example.org/ring_field",
                             "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
                             "why": "a test scene added by files alone"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "progressive",
                               "chips": 1, "why": "the progressive loop over the test scene"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in RENDER_METRICS:
            m["workloads"].append(CELL)
    return bench


def drop_entries(bench: dict) -> dict:
    bench = copy.deepcopy(bench)
    bench["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != CELL]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return bench


def test_a_configuration_and_a_cell_are_new_files_and_entries_only(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / PROGRAM).symlink_to(ROOT / PROGRAM, target_is_directory=True)
    before = digests(tmp_path / "benchmark")
    bench_before = json.loads((tmp_path / "BENCHMARK.json").read_text())

    b = tmp_path / "benchmark"
    (b / "reference" / "generators" / f"{CONFIG}.py").write_text(GENERATOR)
    (b / "configs" / f"{CONFIG}.json").write_text(json.dumps(CONFIG_FILE, indent=2))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS, indent=2))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(add_entries(bench_before), indent=2))

    after = digests(b)
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == {Path("reference/generators/ring_field.py"),
                                        Path("configs/ring_field.json"),
                                        Path("limits/ring_field.progressive.json")}
    bench_after = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert drop_entries(bench_after) == bench_before

    code = ("import json, sys, time\nsys.path[:0] = [%r, %r]\n"
            "from conftest import cpu_forms, tiny\nfrom benchmark import harness\n"
            "from benchmark.reference.scenes import make_scene\n"
            "assert {(%r, 'small'), (%r, 'wide')} <= set(cpu_forms())\n"
            "cell = tiny(%r, 'small')\n"
            "n = len(make_scene(cell.config['scene'], 5)['radii'])\n"
            "res, _ = harness.run_cell(cell, 2**31 + 5, 0.5, False, 'cpu', time.perf_counter())\n"
            "print(json.dumps({'here': str(harness.HERE), 'n': n, 'correct': res['correct'],\n"
            "                  'checks': res['checks'], 'metrics': sorted(res['metrics']),\n"
            "                  'failed': res['failed']}))\n"
            ) % (str(tmp_path), str(b / "tests"), CELL, CELL, CELL)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["here"] == str(b.resolve()) and res["n"] == 61
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["metrics"] == ["render_rays_per_s", "setup_s", "snapshot_p95_ms"]
