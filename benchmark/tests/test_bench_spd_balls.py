"""The sphereflake's arrays do not move (sha256 at size factors 2, 3 and
4, bare and in a run's order), and the readers of the walk's per-layer
metrics read nothing, and do not raise, where a run has no trace, no K9
launch or a program without the walk's counters."""

from __future__ import annotations

import pytest

from benchmark import harness, tracing
from benchmark.reference import scenes

from test_bench_scenes import RUN_SEED, digest

PINNED = {
    2: ("c22f0e865112953085f8e0304d8985a65000e74dd638b87bb79559265042c8c9",
        "0df2378ef39e4f2971834e3be8389f63ddaf027fba492383a15e25146fa65b3a"),
    3: ("ee4c2b3657d04e5aedfa00244893996e2429450d2f603503a35a8123e25817c4",
        "e6cad75d1e4d8bad5316e728b541fb646284fe61049c4e07afc365b4c32ec371"),
    4: ("07dc6e9592c9636c3417304d996676084355a4cdce11f268194025b3c65ed8ba",
        "0af74823f7c20893a84bb85809559c5e30d29f2b495a376c6f14f48462f74bed"),
}


@pytest.mark.parametrize("size_factor", sorted(PINNED))
@pytest.mark.parametrize("order", ["bare", "run_seed"])
def test_spd_balls_arrays_do_not_move(size_factor, order):
    if order == "bare":
        got = scenes.generator("spd_balls")(0, size_factor=size_factor)
    else:
        got = scenes.make_scene({"generator": "spd_balls", "seed": 0,
                                 "size_factor": size_factor}, RUN_SEED)
    assert digest(got) == PINNED[size_factor][order == "run_seed"]


def _record(trace):
    rec = harness.Record(setup_s=1.0, window_s=1.0, times=[0.5], rays=10,
                         units={"images": 1, "samples": 4, "batches": 1, "steps": 1},
                         trace=trace)
    rec.work_sample = lambda: {"bounces": 10, "near": 3, "live": 820}
    return rec


def _no_counters(monkeypatch):
    """The program as a parent without the walk's counters has it."""
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    monkeypatch.delattr(mega_walk_kernel, "walk_tally")
    monkeypatch.delattr(render_progressive, "walk_packs")
    monkeypatch.delattr(render_progressive, "walk_pack_s")


TRACE = tracing.TraceData(spans=[(0, 10)], device=[(1, 5, "mega_render_kernel")],
                          busy=[(1, 5)], window=(0, 10))
CASES = [(m, c) for m in ("k9_ms_per_sample", "k9_record_ms_per_step")
         for c in ("no_trace", "no_k9_launch")] + \
        [(m, c) for m in ("walk_test_share_pct", "walk_pack_ms")
         for c in ("nothing_counted", "no_counters")]


@pytest.mark.parametrize("name,case", CASES, ids=lambda x: x)
def test_walk_readers_read_nothing_without_their_source(name, case, monkeypatch):
    from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    mega_walk_kernel.walk_tally()  # no walk launched since
    monkeypatch.setattr(render_progressive, "walk_packs", 0)
    if case == "no_counters":
        _no_counters(monkeypatch)
    assert harness.metric_reader(name)(_record(None if case == "no_trace" else TRACE)) is None
