"""The harness end to end on the CPU at a tiny size: every cell measures a
window, reads its metrics and comes out correct against the reference,
which meets the program's plain versions to the bit."""

from __future__ import annotations

import time

from benchmark import harness


def test_untraced_run_reports_end_to_end_metrics_and_is_correct(cell):
    res, rec = harness.run_cell(cell, 2**31 + 99, 0.5, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == len(rec.times) >= 1
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert len(rec.gaps) == rec.units.get("batches", 0)
    assert all(c["value"] == 0.0 for k, c in res["checks"].items() if not k.startswith("grad"))


def test_traced_run_reports_host_side_layer_metrics(cell):
    res, rec = harness.run_cell(cell, 7, 0.5, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    # no device on the CPU: the kernel metrics find nothing to read and are left out
    assert names == {m["name"] for m in cell.per_layer
                     if not m["name"].startswith(("k5_", "k6_", "k8_", "k9_"))}
    assert len(rec.trace.spans) == len(rec.times)
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(cell):
    a = harness.make_driver(cell, 123456789012, "cpu")
    b = harness.make_driver(cell, 123456789012, "cpu")
    c = harness.make_driver(cell, 123456789013, "cpu")
    for d in (a, b, c):
        d.setup()
    assert all((a.arrays[k] == b.arrays[k]).all() for k in a.arrays)
    assert any(a.arrays[k].shape != c.arrays[k].shape or (a.arrays[k] != c.arrays[k]).any()
               for k in a.arrays)
