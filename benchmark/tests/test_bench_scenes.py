"""The scenes a configuration names are files found by name: the book's
final scene gives the same arrays to the bit as before it moved into
reference/generators/, bare and in a run's order, and a name with no
file is an error that names the file."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from benchmark.reference import scenes

RUN_SEED = 2**31 + 99
# sha256 of the arrays (sorted by name; each name, dtype, shape and bytes),
# taken before the generator moved out of scenes.py
PINNED = {
    11: ("be7ae0c393cc48a5ed94419ef345f5954df03f0d3e814a1b9c96e3dcc85c1a25",
         "f6a46eed9a20efe455c8c0d90e53a1ce77c304fae7d5414092bf4f0ce42139e3"),
    3: ("9d52c0d5840abece66b90db8579e676eeb37125c4811e26af414f2ebc263d096",
        "1af3f827cf612a98ece63be73daf402e389766fa60bbecbe7a00eb032d9078bc"),
    12: ("39c9cb6362253efbafa891f4ae614f3767c5f4c5edb9276078cd594531a98916",
         "e1c32a2db1b19b412c1f2534922832db803bfcc4cb6d2055bbc737a05a1ff3a5"),
}


def digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("grid", sorted(PINNED))
@pytest.mark.parametrize("order", ["bare", "run_seed"])
def test_rtiow_final_arrays_do_not_move(grid, order):
    if order == "bare":
        got = scenes.generator("rtiow_final")(0, grid=grid)
    else:
        got = scenes.make_scene({"generator": "rtiow_final", "seed": 0, "grid": grid}, RUN_SEED)
    assert digest(got) == PINNED[grid][order == "run_seed"]


def test_unknown_generator_names_its_missing_file():
    with pytest.raises(FileNotFoundError, match=r"generators/no_such_scene\.py"):
        scenes.make_scene({"generator": "no_such_scene", "seed": 0}, 1)
