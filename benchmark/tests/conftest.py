"""Shared set-up of the benchmark's own tests: the repository root on the
path, and every cell of BENCHMARK.json cut to a size the CPU runs in a
second, once for each of its configuration's CPU forms."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def cpu_forms() -> list:
    """(cell, form) for every cell and every form of its configuration's
    "cpu_forms": overrides of its "scene" entry, such as a small scene
    and one past the 512 spheres of one dense sweep (the walk)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    out = []
    for w in bench["workloads"]:
        forms = json.loads((ROOT / files[w["config"]]).read_text())["cpu_forms"]
        out += [(w["name"], f) for f in forms]
    return out


def tiny(name: str, form: str):
    """The cell with a 32-pixel-wide image, depth 8, 20 samples per pixel
    (a full batch and a shorter last one), its scene in the CPU form
    `form`, and a small check."""
    from benchmark import harness

    cell = harness.load_cell(name)
    cell.config["camera"].update(image_width=32, max_depth=8, samples_per_pixel=20)
    cell.config["scene"] = {**cell.config["scene"], **cell.config["cpu_forms"][form]}
    if "images" in cell.limits["check"]:
        cell.limits["check"] = {"images": 3, "pixels": 64}
    return cell


@pytest.fixture(params=cpu_forms(), ids=lambda p: f"{p[0]}.{p[1]}")
def cell(request):
    return tiny(*request.param)
