"""The lane-use reckonings of the persistent kernels (ops/kernels/mega_kernel.py).

static_lane_use is the share of lanes that one thread per ray in static
warps of 32 consecutive rays keeps busy, reckoned from the rays' bounce
counts; lane_use is the persistent kernels' own, from their bounce (or
row) and warp-step counters; sweep_lane_use is the walk's (K9), from its
per-lane slot tests and the slot tests its warps issued; group_lane_use
is the group walk's (K14, K12/K13), from the slot tests and the slot-test
lanes its groups issued.  chip_smoke.py reports them at the main path.  These run on the CPU on synthetic counts
with known answers; no JAX."""

import pytest
import torch

from distributed_raytracer_tpu_torch.ops.kernels.mega_kernel import (
    group_lane_use,
    lane_use,
    static_lane_use,
    sweep_lane_use,
)


@pytest.mark.parametrize("lengths,want", [
    # one warp, every ray 3 bounces: every lane busy
    ([3] * 32, 1.0),
    # one long ray holds its warp: 31 x 1 + 50 over 32 x 50
    ([1] * 31 + [50], 81 / 1600),
    # two warps and a partial third, which counts as a whole warp:
    # (31 + 5 + 64 + 30) / (32 x (5 + 2 + 3))
    ([1] * 31 + [5] + [2] * 32 + [3] * 10, 130 / 320),
    # rays that ran no bounce (n_valid < n_cap rows) and a warp of them
    ([0] * 32 + [4] * 16 + [0] * 16, 64 / 128),
])
def test_static_lane_use(lengths, want):
    got = static_lane_use(torch.tensor(lengths, dtype=torch.int32))
    assert got == pytest.approx(want, rel=1e-12)


def test_static_lane_use_of_the_warp_width():
    lengths = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8])
    # warps of 4: (1+2+3+4 + 5+6+7+8) / (4 x (4 + 8))
    assert static_lane_use(lengths, warp=4) == pytest.approx(36 / 48, rel=1e-12)
    assert static_lane_use(lengths, warp=1) == 1.0


def test_static_lane_use_without_bounces():
    assert static_lane_use(torch.zeros(64, dtype=torch.int32)) == 0.0


@pytest.mark.parametrize("bounces,steps,want", [
    (320, 10, 1.0),         # every swept warp full
    (2372645, 100000, 2372645 / 3200000),
    (7, 1, 7 / 32),         # one warp, seven rays
    (0, 0, 0.0),            # nothing swept
])
def test_lane_use_from_counters(bounces, steps, want):
    assert lane_use(bounces, steps) == pytest.approx(want, rel=1e-12)


def test_static_warps_bound_the_counters():
    """On any lengths, static warps of 32 never beat a schedule that
    packs the same bounces into full warps: static_lane_use is at most
    the lane use of ceil(bounces / 32) full warp steps."""
    g = torch.Generator().manual_seed(0)
    for _ in range(10):
        n = int(torch.randint(1, 300, (1,), generator=g))
        lengths = torch.randint(0, 51, (n,), generator=g)
        b = int(lengths.sum())
        packed = lane_use(b, -(-b // 32))
        assert static_lane_use(lengths) <= packed <= 1.0


@pytest.mark.parametrize("tests,warp_tests,want", [
    # every lane of every warp admitted every chunk its warp swept
    (32 * 256, 256, 1.0),
    # one lane of 32 admitted the chunk, the warp swept it once
    (256, 256, 1 / 32),
    # a chunk of 256 slots admitted by 8 lanes, another of 100 by 32
    (8 * 256 + 32 * 100, 256 + 100, (8 * 256 + 32 * 100) / (32 * 356)),
    # no chunk swept
    (0, 0, 0.0),
])
def test_sweep_lane_use(tests, warp_tests, want):
    assert sweep_lane_use(tests, warp_tests) == pytest.approx(want, rel=1e-12)


def test_sweep_lane_use_of_the_warp_width():
    # warps of 4 lanes: 3 of 4 admitted a 10-slot chunk, then 1 of 4 a 2-slot one
    assert sweep_lane_use(3 * 10 + 1 * 2, 10 + 2, warp=4) == pytest.approx(32 / 48, rel=1e-12)
    assert sweep_lane_use(7, 7, warp=1) == 1.0


def test_sweep_lane_use_bounds():
    """Each warp slot test stands for between 1 and 32 lane slot tests, so
    sweep_lane_use lies in [1/32, 1] whenever a chunk was swept."""
    g = torch.Generator().manual_seed(1)
    for _ in range(10):
        lens = torch.randint(1, 257, (20,), generator=g)
        lanes = torch.randint(1, 33, (20,), generator=g)
        got = sweep_lane_use(int((lens * lanes).sum()), int(lens.sum()))
        assert 1 / 32 <= got <= 1.0


def _issued(lens, group):
    """The slot-test lanes a group of `group` lanes issues for chunks of
    these lengths: group x ceil(len / group) each."""
    return sum(group * -(-n // group) for n in lens)


@pytest.mark.parametrize("lens,group,want", [
    # full chunks of 128 swept by warps: no lane idles
    ([128] * 13, 32, 1.0),
    # the always-swept ground chunk holds one sphere: 1 of 32 lanes busy
    ([1], 32, 1 / 32),
    # the ground chunk and 13 full chunks at G = 32
    ([1] + [128] * 13, 32, (1 + 13 * 128) / (32 + 13 * 128)),
    # the final scene's last chunk of 102 slots at G = 8: 13 rounds of 8
    ([102], 8, 102 / 104),
    # one lane per ray (G = 1) never idles
    ([1, 102, 128], 1, 1.0),
    # nothing admitted
    ([], 16, 0.0),
])
def test_group_lane_use(lens, group, want):
    assert group_lane_use(sum(lens), _issued(lens, group)) == pytest.approx(want, rel=1e-12)


def test_group_lane_use_bounds():
    """Only a chunk's last round can leave lanes idle, so the group lane use
    of chunks of at least G slots is above one half, and a larger G never
    raises it."""
    g = torch.Generator().manual_seed(2)
    for _ in range(10):
        lens = torch.randint(32, 257, (20,), generator=g).tolist()
        uses = [group_lane_use(sum(lens), _issued(lens, group)) for group in (1, 4, 8, 16, 32)]
        assert uses[0] == 1.0 and all(0.5 < u <= 1.0 for u in uses)
        assert all(a >= b for a, b in zip(uses, uses[1:]))
