"""The port imports no JAX and nothing of the JAX package."""

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_raytracer_tpu_torch"
# names that must never be loaded by the port (exact module or its children)
FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_raytracer_tpu")


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    mods = _modules()
    assert "distributed_raytracer_tpu_torch.cli" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("suffix", ["*.py", "*.cu", "*.cuh"])
def test_port_sources_name_no_jax_module(suffix):
    for p in PKG.rglob(suffix):
        text = p.read_text()
        assert "distributed_raytracer_tpu." not in text, p
        assert "import jax" not in text and "from jax" not in text, p
