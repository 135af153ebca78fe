"""The port's ctypes loader of the native host runtime.

`shuffled_indices`, `tonemap_bytes`, `tonemap_pack`, `accumulate` and
`mean_pack` call `dray_shuffle`, `dray_tonemap_bytes`, `dray_tonemap_pack`,
`dray_accumulate` and `dray_mean_pack`: the shuffled fill's pixel order, the
gamma-2 tonemap to bytes or to packed 0xFFRRGGBB words, and the raw-sum and
count accumulation of the fill.  Each has a NumPy fallback that gives the
same bits: the shuffle is the same splitmix64 Fisher-Yates in uint64, so
the permutation is one function of the seed on every host (the JAX
package's fallback shuffles with numpy's default_rng instead), and the
tonemaps are render/image.py's to_bytes and pack_argb in float32.

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

from distributed_raytracer_tpu_torch.render.image import pack_argb, to_bytes

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
        i64 = ctypes.c_int64
        u8p, u32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
        lib.dray_shuffle.argtypes = [i32p, i64, ctypes.c_uint64]
        lib.dray_tonemap_bytes.argtypes = [f32p, i64, u8p]
        lib.dray_tonemap_pack.argtypes = [f32p, i64, u32p]
        lib.dray_accumulate.argtypes = [f32p, i32p, f32p, i32p, i64, i64]
        lib.dray_mean_pack.argtypes = [f32p, i32p, i64, u32p]
        for fn in (lib.dray_shuffle, lib.dray_tonemap_bytes, lib.dray_tonemap_pack,
                   lib.dray_accumulate, lib.dray_mean_pack):
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """True when the entry points run the C++ library."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


_M64 = 0xFFFFFFFFFFFFFFFF


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """[n] int32, a permutation of 0..n-1 that is a function of seed (taken
    mod 2^64): the shuffled fill's pixel order."""
    idx = np.arange(n, dtype=np.int32)
    lib = _load()
    if lib is None:
        return _shuffle_numpy(idx, seed)
    lib.dray_shuffle(_ptr(idx, ctypes.c_int32), n, seed & _M64)
    return idx


def _shuffle_numpy(idx: np.ndarray, seed: int) -> np.ndarray:
    """dray_shuffle in NumPy: Fisher-Yates from i = n-1 down to 1, swapping
    i with splitmix64's k-th output mod (i + 1), k = 1, 2, ...; splitmix64's
    k-th state is seed + k * 0x9E3779B97F4A7C15, so the draws are computed
    at once in uint64 and only the swaps run in order."""
    n = len(idx)
    if n < 2:
        return idx
    with np.errstate(over="ignore"):
        z = np.uint64(seed & _M64) + np.arange(1, n, dtype=np.uint64) * np.uint64(
            0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    i = np.arange(n - 1, 0, -1, dtype=np.uint64)
    js = (z % (i + np.uint64(1))).tolist()
    out = idx.tolist()
    for i, j in zip(range(n - 1, 0, -1), js):
        out[i], out[j] = out[j], out[i]
    return np.asarray(out, np.int32)


def _rgb(linear_rgb) -> np.ndarray:
    rgb = np.ascontiguousarray(linear_rgb, np.float32)
    if rgb.shape[-1:] != (3,):
        raise ValueError(f"need [..., 3] colors, got shape {rgb.shape}")
    return rgb


def tonemap_bytes(linear_rgb: np.ndarray) -> np.ndarray:
    """Linear [..., 3] colors -> uint8 [..., 3]: gamma-2, clamp to
    [0, 0.999], 255.999 scale (render/image.py to_bytes in float32)."""
    rgb = _rgb(linear_rgb)
    lib = _load()
    if lib is None:
        return to_bytes(rgb)
    out = np.empty(rgb.shape, np.uint8)
    lib.dray_tonemap_bytes(_ptr(rgb, ctypes.c_float), rgb.size // 3, _ptr(out, ctypes.c_uint8))
    return out


def tonemap_pack(linear_rgb: np.ndarray) -> np.ndarray:
    """Linear [..., 3] colors -> uint32 [...] 0xFFRRGGBB (render/image.py
    pack_argb)."""
    rgb = _rgb(linear_rgb)
    lib = _load()
    if lib is None:
        return pack_argb(rgb)
    out = np.empty(rgb.shape[:-1], np.uint32)
    lib.dray_tonemap_pack(_ptr(rgb, ctypes.c_float), rgb.size // 3, _ptr(out, ctypes.c_uint32))
    return out


def accumulate(raw: np.ndarray, count: np.ndarray, colors: np.ndarray,
               pixel_ids: np.ndarray) -> None:
    """In place: raw[p] += colors[i] and count[p] += 1 for p = pixel_ids[i],
    in the order of the ids; ids outside [0, len(count)) are skipped.  raw
    is [n_pix, 3] float32 and count [n_pix] int32, both C-contiguous."""
    if not (raw.dtype == np.float32 and count.dtype == np.int32 and raw.flags.c_contiguous
            and count.flags.c_contiguous and raw.shape == (len(count), 3)):
        raise ValueError("accumulate needs C-contiguous raw [n, 3] float32 and count [n] int32")
    colors = np.ascontiguousarray(colors, np.float32).reshape(-1, 3)
    pixel_ids = np.ascontiguousarray(pixel_ids, np.int32).reshape(-1)
    if len(colors) != len(pixel_ids):
        raise ValueError(f"{len(colors)} colors for {len(pixel_ids)} pixel ids")
    lib = _load()
    if lib is None:
        ok = (pixel_ids >= 0) & (pixel_ids < len(count))
        np.add.at(raw, pixel_ids[ok], colors[ok])
        np.add.at(count, pixel_ids[ok], 1)
        return
    lib.dray_accumulate(_ptr(raw, ctypes.c_float), _ptr(count, ctypes.c_int32),
                        _ptr(colors, ctypes.c_float), _ptr(pixel_ids, ctypes.c_int32),
                        len(pixel_ids), len(count))


def mean_pack(raw: np.ndarray, count: np.ndarray) -> np.ndarray:
    """uint32 [n_pix] 0xFFRRGGBB of the mean raw / count (a count of 0
    divides by 1)."""
    raw = np.ascontiguousarray(raw, np.float32).reshape(-1, 3)
    count = np.ascontiguousarray(count, np.int32).reshape(-1)
    if len(raw) != len(count):
        raise ValueError(f"{len(raw)} sums for {len(count)} counts")
    lib = _load()
    if lib is None:
        denom = np.where(count != 0, count, 1).astype(np.float32)[:, None]
        return pack_argb(raw / denom)
    out = np.empty(len(count), np.uint32)
    lib.dray_mean_pack(_ptr(raw, ctypes.c_float), _ptr(count, ctypes.c_int32), len(count),
                       _ptr(out, ctypes.c_uint32))
    return out


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
