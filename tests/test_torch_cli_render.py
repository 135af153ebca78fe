"""The port's `render` command on the CPU: _resolve_engine's table (JAX's
cli.py:80-109, the card standing in for a TPU), --job precedence, the job
record beside the checkpoint against the JAX package's _job_config for the
same arguments, --snapshot-every with --fill shuffled, --wavefront, and
utils/metrics.py (RenderMetrics against JAX's report, timed_best,
profiler_trace)."""

import argparse
import io
import json
import os

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu import cli as jcli
from distributed_raytracer_tpu.utils.metrics import RenderMetrics as JaxMetrics
from distributed_raytracer_tpu_torch import cli
from distributed_raytracer_tpu_torch.render.image import read_ppm
from distributed_raytracer_tpu_torch.render.progressive import AccumState
from distributed_raytracer_tpu_torch.utils.config import RenderJobConfig
from distributed_raytracer_tpu_torch.utils.metrics import RenderMetrics, profiler_trace, timed_best


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("flags,cpu,want", [
    ([], False, "mega"), ([], True, "scan"),
    (["--wavefront"], False, "wavefront"), (["--wavefront"], True, "wavefront"),
    (["--engine", "fused"], True, "fused"), (["--engine", "scan", "--wavefront"], True, "scan"),
    (["--accel", "culled"], False, "mega"), (["--accel", "culled"], True, "wavefront"),
    (["--accel", "culled", "--wavefront"], False, "wavefront"),
    (["--accel", "culled", "--engine", "scan"], False, "wavefront"),
    (["--accel", "culled", "--engine", "fused"], True, "fused"),
    (["--accel", "culled", "--engine", "mega"], True, "mega"),
])
def test_resolve_engine_table(flags, cpu, want, capsys):
    args = cli.parse_args(["render", *flags, *(["--cpu"] if cpu else [])])
    assert cli._resolve_engine(args) == want
    # JAX's table, the card standing in for a TPU
    platform = "cpu" if cpu else "tpu"
    fake = argparse.Namespace(devices=lambda: [argparse.Namespace(platform=platform)])
    assert jcli._resolve_engine(args, fake) == want
    if "scan" in flags and "culled" in flags:
        assert "requires a wavefront engine" in capsys.readouterr().err


def test_job_precedence(tmp_path):
    job = RenderJobConfig(preset="config2", seed=5, spp=3, batch=2, output="j.ppm",
                          engine="scan", fill="shuffled", checkpoint_path="j.ckpt")
    jp = str(tmp_path / "job.json")
    with open(jp, "w") as f:
        f.write(job.to_json())
    args = cli.parse_args(["render", "--job", jp, "--seed", "9", "--batch=4"])
    assert (args.config, args.seed, args.spp, args.batch, args.out, args.engine, args.fill,
            args.checkpoint) == ("config2", 9, 3, 4, "j.ppm", "scan", "shuffled", "j.ckpt")
    with pytest.raises(SystemExit):  # no abbreviations: --check would slip past the job
        cli.parse_args(["render", "--job", jp, "--check", "x"])


def test_job_record_and_snapshots(tmp_path, capsys):
    out, ck = str(tmp_path / "s.ppm"), str(tmp_path / "s.ckpt")
    argv = ["render", "--config", "config1", "--spp", "3", "--width", "32", "--batch", "2",
            "--fill", "shuffled", "--fill-chunk", "200", "--snapshot-every", "1",
            "--checkpoint", ck, "--out", out, "--cpu"]
    writes = []
    import distributed_raytracer_tpu_torch.render.image as image

    real = image.write_ppm

    def spy(path, img):
        writes.append(path)
        real(path, img)

    image.write_ppm = spy
    try:
        cli.main(argv)
    finally:
        image.write_ppm = real
    # three fill chunks, samples 1 and 3, the final image
    assert writes == [out] * 6
    args = cli.parse_args(argv)
    with open(ck + ".json") as f:
        text = f.read()
    assert text == jcli._job_config(args, "scan").to_json()
    assert RenderJobConfig.from_json(text).engine == "scan"
    st = AccumState.load(ck)
    assert (st.samples_done, st.engine, st.batch) == (3, "scan", 2)
    img = read_ppm(out)
    assert img.shape == (18, 32, 3) and img.mean() > 0
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("{")]
    report = json.loads(lines[-1])
    assert report["samples_done"] == 3 and report["rays_traced"] == 3 * 32 * 18
    assert set(report) == {"rays_traced", "samples_done", "rays_per_sec", "phases"}


def test_wavefront_flag(tmp_path, capsys):
    out = str(tmp_path / "w.ppm")
    cli.main(["render", "--config", "config1", "--spp", "1", "--width", "16", "--wavefront",
              "--cpu", "--out", out])
    assert "engine=wavefront" in capsys.readouterr().err and os.path.exists(out)


def test_render_metrics_report_matches_jax():
    got, want = RenderMetrics(), JaxMetrics()
    for m in (got, want):
        m.add_rays(1234567)
        m.samples_done = 7
        m.phase_seconds.update(render=1.23456789, fill=0.0004321)
    a, b = io.StringIO(), io.StringIO()
    got.report(a)
    want.report(b)
    assert a.getvalue() == b.getvalue()
    with got.phase("more"):
        pass
    assert got.phase_seconds["more"] >= 0.0 and got.rays_per_sec > 0


def test_timed_best_and_profiler_trace(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return torch.ones(4) * x

    blocked = []
    s = timed_best(fn, 2.0, iters=3, reps=2, block_until_ready=blocked.append)
    assert s >= 0.0 and len(calls) == 1 + 3 * 2 and len(blocked) == 3
    assert timed_best(fn, 1.0, iters=1) >= 0.0  # the default blocker on CPU tensors
    with profiler_trace(None):
        pass
    logdir = str(tmp_path / "trace")
    with profiler_trace(logdir):
        (torch.ones(64) * 2).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
