"""Builds the port's CUDA sources at first use and loads them with ctypes.

`csrc/<name>.cu` is compiled by `nvcc` into a shared library with a plain
C interface, under `build/kernels/` at the repository root, named by a
hash of all the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no contraction into FMAs, so each kernel computes what its plain
    # PyTorch version computes, operation for operation
    "-fmad=false",
    "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_grids: Dict[tuple, int] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (CUDA toolkit needed to build the kernels)")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, str]:
    """Compile `csrc/<name>.cu` for each name not built already, one nvcc
    per source, all started together.  Returns each name's ptxas report
    (the registers and shared memory of its kernels), empty when the
    library was already built; raises if any nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (p, tmp, out) in procs.items():
        reports[name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {p.returncode}):\n{reports[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def occupancy_grid(name: str, symbol: str, device: torch.device, *args: int) -> int:
    """The grid of a persistent kernel of `csrc/<name>.cu`: the card's SMs
    times the blocks per SM that `symbol(*args)` reads from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; cached per device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    key = (name, symbol, args, index)
    if key not in _grids:
        fn = getattr(load(name), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        with torch.cuda.device(index):
            per_sm = fn(*args)
        if per_sm < 1:
            raise RuntimeError(f"{symbol}: CUDA error {-per_sm} (or no block fits an SM)")
        _grids[key] = per_sm * torch.cuda.get_device_properties(index).multi_processor_count
    return _grids[key]
