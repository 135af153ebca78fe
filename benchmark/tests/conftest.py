"""Shared set-up of the benchmark's own tests: the repository root on the
path, and the cells cut to a size the CPU runs in a second."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

CELLS = ("rtiow_final.progressive", "rtiow_final.train")
# the book's grid widened to 24 x 24, past the 512 spheres of one dense sweep:
# on such a scene the program takes its walk (K9 render, the walk tracer)
WIDE = {"generator": "rtiow_final", "seed": 0, "grid": 12}


def tiny(name: str, wide: bool = False):
    """The cell with a 32-pixel-wide image, depth 8, 20 samples per pixel
    (a full batch and a shorter last one), a 3 x 3 grid or, with wide,
    the 24 x 24 one, and a small check."""
    from benchmark import harness

    cell = harness.load_cell(name)
    cell.config["camera"].update(image_width=32, max_depth=8, samples_per_pixel=20)
    cell.config["scene"] = dict(WIDE) if wide else {**cell.config["scene"], "grid": 3}
    if "images" in cell.limits["check"]:
        cell.limits["check"] = {"images": 3, "pixels": 64}
    return cell


@pytest.fixture(params=[(c, f) for c in CELLS for f in (False, True)],
                ids=lambda p: p[0] + (".wide" if p[1] else ""))
def cell(request):
    return tiny(*request.param)
