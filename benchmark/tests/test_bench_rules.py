"""The rules around a run: the import rule (whole top-level module names;
the reference imports nothing of the program), no result without a card
or without the program, and the trace reduction's arithmetic."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness, tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "distributed_raytracer_tpu_torch_x",
                        types.ModuleType("x"))
    assert "distributed_raytracer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "distributed_raytracer_tpu.models",
                        types.ModuleType("m"))
    assert "distributed_raytracer_tpu" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program_or_jax():
    for f in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top in {"__future__", "numpy", "torch", "typing", "benchmark"}, (f, n)
                assert not n.startswith("benchmark.") or n.startswith("benchmark.reference"), (f, n)


def test_a_cpu_run_loads_no_jax_module():
    code = ("import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from conftest import tiny\nfrom benchmark import harness\n"
            "res, _ = harness.run_cell(tiny('rtiow_final.train', True), 3, 0.3, True, 'cpu', "
            "time.perf_counter())\nassert res['correct']\n"
            "print(harness.forbidden_modules())\n") % (str(ROOT), str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd: Path):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "rtiow_final.progressive", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_result_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "distributed_raytracer_tpu_torch" in out.stderr


def test_trace_reduction_arithmetic():
    assert tracing.merge([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    busy = [(0, 4), (5, 10)]
    assert tracing.covered(busy, [0, 5], 3, 7) == 3
    assert tracing.short_name("void mega_walk_kernel<true>(float4 const*, int)") == \
        "mega_walk_kernel<true>"
    host = [(0, 20, 1, tracing.SPAN), (4, 6, 1, "aten::copy_"), (12, 20, 1, "aten::item"),
            (14, 16, 1, "cudaStreamSynchronize"), (0, 20, 2, "other thread")]
    gaps = tracing._gaps_by_host([(1, 4), (6, 12), (15, 17)], (0, 20), host)
    assert gaps == pytest.approx({tracing.SPAN: 1e-9, "aten::copy_": 2e-9,
                                  "aten::item": 2e-9 + 3e-9, "cudaStreamSynchronize": 1e-9})


def test_benchmark_json_names_a_file_for_every_cell_part():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


@pytest.mark.cuda
def test_card_runs_every_cell_correctly():
    """On the card: each cell once, short, with the real limits."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())
                 ["workloads"]]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                              "--seed", "987654321987", "--seconds", "2", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
