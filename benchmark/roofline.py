"""The yardstick of the kernels' rooflines: the card's published peak and
the floating-point operations that a closest-hit sweep needs, counted by
the reference from the inputs (not from the program's tape or counters),
so the count is the same whatever kernel does the work."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 outside the tensor cores
# (dense), at the full 700 W power limit; the run records the card's limit.
PEAK_FP32_FLOPS = 67e12
# one ray x sphere test of the dense sweep: oc 3, h 5, c_q 6, disc 3, the
# compare 1; a test whose discriminant is not negative adds sqrt, the two
# roots (2 each) and three compares (an FMA counts as two operations)
FLOPS_PER_TEST = 18
FLOPS_PER_NEAR_TEST = 8


def sweep_flops(work: dict) -> float:
    """Operations of one sample: every closest hit against every live
    sphere, and the tests with a discriminant not negative."""
    return work["bounces"] * work["live"] * FLOPS_PER_TEST + work["near"] * FLOPS_PER_NEAR_TEST


def roofline_pct(work: dict, launch_s: list) -> float:
    """The least time of one sample over the mean launch time, in %."""
    if not launch_s:
        return None
    return 100.0 * sweep_flops(work) / PEAK_FP32_FLOPS / (sum(launch_s) / len(launch_s))
