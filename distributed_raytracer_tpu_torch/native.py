"""The port's ctypes loader of the native cluster builder.

`build_clusters` Morton-sorts sphere centers and bounds each run of
`cluster_size` spheres with a sphere: the walk engine's chunks
(ops/kernels/culled_kernel.py).  It calls `dray_build_clusters` of
native/dray_native.cpp, compiled by `g++ -O2 -shared -fPIC` into
`build/native/` at the repository root at first use (named by a hash of
the source, so an edited source rebuilds).  Without a C++ compiler it
runs `_build_clusters_numpy`, the same algorithm in NumPy (a copy of
distributed_raytracer_tpu/native.py's fallback); that fallback normalizes
and bounds in float32 where the C++ uses double, so its order and bounds
can differ from the C++ builder's in the last bits.  Both round the
bound radius to float32, so a bound can fall short of covering a member
sphere by about one ulp of the radius (tests/test_torch_mega_walk.py::
test_numpy_cluster_builder measures it), far below the float32 rounding
of the walk's own bound test; the walk is held to the dense sweep bit for
bit in the tests and in chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "dray_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdray_native-{h.hexdigest()[:16]}.so"


def _load() -> Optional[ctypes.CDLL]:
    """The built library, compiled first if needed; None when no C++
    compiler is found.  A compiler that fails raises."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = _library_path()
        if not out.exists():
            cxx = shutil.which(os.environ.get("CXX", "g++"))
            if cxx is None:
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.dray_build_clusters.argtypes = [f32p, f32p, ctypes.c_int32, ctypes.c_int32, i32p,
                                            f32p]
        lib.dray_build_clusters.restype = ctypes.c_int32
        _lib = lib
        return lib


def available() -> bool:
    """True when build_clusters runs the C++ builder."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_clusters(centers: np.ndarray, radii: np.ndarray,
                   cluster_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Morton-sort spheres and bound each cluster of cluster_size.

    Returns (order [n] int32: new position -> old index, cluster_bounds
    [n_clusters, 4] f32 as (cx, cy, cz, r), r covering every member
    sphere's radius)."""
    centers = np.ascontiguousarray(centers, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    n = len(radii)
    lib = _load()
    if lib is None:
        return _build_clusters_numpy(centers, radii, cluster_size)
    order = np.empty(n, np.int32)
    bounds = np.empty((-(-n // cluster_size), 4), np.float32)
    nc = lib.dray_build_clusters(_ptr(centers, ctypes.c_float), _ptr(radii, ctypes.c_float), n,
                                 cluster_size, _ptr(order, ctypes.c_int32),
                                 _ptr(bounds, ctypes.c_float))
    return order, bounds[:nc]


def _build_clusters_numpy(centers: np.ndarray, radii: np.ndarray,
                          cluster_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The NumPy version of build_clusters (float32 arithmetic)."""
    n = len(radii)
    lo = centers.min(0)
    span = np.maximum(centers.max(0) - lo, 1e-12)
    q = np.clip((centers - lo) / span, 0, 1 - 1e-9)
    qi = (q * 2097151.0).astype(np.uint64)

    def expand(v):
        v = v & np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    code = ((expand(qi[:, 0]) << np.uint64(2)) | (expand(qi[:, 1]) << np.uint64(1))
            | expand(qi[:, 2]))
    order = np.argsort(code, kind="stable").astype(np.int32)
    bounds = []
    for c in range(-(-n // cluster_size)):
        m = order[c * cluster_size:(c + 1) * cluster_size]
        ctr = centers[m].mean(0)
        r = np.max(np.linalg.norm(centers[m] - ctr, axis=-1) + radii[m])
        bounds.append([*ctr, r])
    return order, np.asarray(bounds, np.float32).reshape(-1, 4)
