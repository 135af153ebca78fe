"""The comparison that decides `correct` fails where it must: the control
(the reference in bfloat16 put in the program's place) and each fault
planted under the timed path come out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import faults, harness, tracing


def test_control_in_lower_precision_is_not_correct(cell):
    drv = harness.make_driver(cell, 31337, "cpu")
    drv.setup()
    lp = harness.closed_loop(drv, 0.5, tracing.Window(False))
    drv.release()
    assert harness.verdict(cell, drv.check(torch.float32), lp)[0]
    drv.put_reference(torch.bfloat16)
    ok, checks = harness.verdict(cell, drv.check(torch.float32), lp)
    assert not ok, checks


@pytest.mark.parametrize("kind", faults.FAULTS)
def test_fault_under_the_timed_path_is_not_correct(cell, kind):
    with faults.planted(kind):
        res, _ = harness.run_cell(cell, 2024, 0.5, False, "cpu", time.perf_counter())
    assert not res["correct"], res["checks"]


def test_faults_restore_the_program():
    from benchmark import port

    before = port.render_progressive, port.image_loss
    with faults.planted("half"):
        assert port.render_progressive is not before[0]
    assert (port.render_progressive, port.image_loss) == before
