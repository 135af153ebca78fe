"""The dense sweep of K10 and K11 (csrc/trace.cuh group_sweep: G lanes per
ray) as a plain schedule model, ops/kernels/culled_kernel.py::
group_sweep_plain, against the sweep of one thread per ray, on the CPU.

The model runs the kernel's schedule: lane q tests spheres q, q + G, ...,
each lane keeps its first least t, and the group's least (t, index) wins.
It must give closest_hit_plain's t and idx (K11's plain version) and
fused_bounce_plain's idx, hit and counters (K10's) bit for bit, and the
tests with disc >= 0 that the sweep of one thread per ray counts, for
G = 1, 4, 8, 16 and 32.  The scene is synthetic: 301 spheres (a multiple
of no G above 1), the R = 1000 ground, a sphere of radius 0 (packed with
r^2 = -1) and two identical spheres, 7 and 289, which fall in different
lanes at every G > 1, the lower index in the higher lane, so an exact tie
must go to the lower index; the rays include grazing ones, misses, rays at
the twins and, for the bounce, inactive lanes.  The tie scene is also held
once against the JAX package's closest_hit_pallas in interpret mode (as
tests/test_torch_intersect.py runs it) on its rays that graze no sphere:
idx and hit equal, and both t within 2e-3 relative of the float64 root on
the winner (test_torch_intersect.py's referee band: near a rim the
root's rounding grows, and XLA:CPU and torch round it apart, measured
5.8e-5 relative between them on this scene).  A grazing test, float64 |disc| below 1e-6 of h^2 +
a |oc|^2 (the size of its terms; a float32 ulp is 6e-8 of it), is one
whose float32 discriminant XLA:CPU and torch may round to opposite signs
(measured: one ray aimed at a rim, |disc| 5.5e-8 of its terms, hit by
JAX at t = 0.99920 and missed by torch; float64 hits at 0.99934); the 54
rays with a grazing test are held to the plain versions above, bit for
bit.  The scene is built in tests/test_torch_dense_scene.py, which the
card tests (tests/test_torch_cuda.py) share; JAX is imported by the
interpret-mode check's fixture alone."""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.core.vecmath import BIG
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
from distributed_raytracer_tpu_torch.ops.kernels.bounce import sweep_t
from test_torch_dense_scene import N, PAD, TWINS, tie_arrays, tie_rays

GROUPS = [1, 4, 8, 16, 32]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for this module's tests, restored after them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    arrays = tie_arrays()
    o, d = tie_rays(arrays)
    scene = Scene.from_numpy(arrays, "cpu")
    sph = ik.sphere_pack(scene.centers, scene.radii)
    return arrays, scene, sph, torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module")
def jax_tie(setup):
    """JAX's closest_hit_pallas on the tie scene, in interpret mode."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from distributed_raytracer_tpu.models.scene import Scene as JScene
    from distributed_raytracer_tpu.ops.pallas.intersect_kernel import (
        closest_hit_pallas as jax_k11,
    )

    arrays, _, _, o, d = setup
    scene = JScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    with pltpu.force_tpu_interpret_mode():
        want = jax_k11(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), scene)
    return want


def _sweep(o, d, sph):
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    return sweep_t(ox, oy, oz, dx, dy, dz, a, 1.0 / a, sph.t())


def test_scene_holds_the_cases(setup):
    """No G above 1 divides n; the padded sphere never hits; the twins tie
    exactly and the lower one wins; some rays graze, some miss, some hit
    the ground."""
    arrays, _, sph, o, d = setup
    assert all(N % g for g in GROUPS[1:])
    assert float(sph[PAD, 3]) == -1.0
    t, ok = _sweep(o, d, sph)
    assert not bool(ok[:, PAD].any())
    tmin, idx = t.min(1)
    assert torch.equal(t[:, TWINS[0]], t[:, TWINS[1]])
    assert int((idx == TWINS[0]).sum()) >= 10
    assert int((tmin >= BIG).sum()) >= 10
    assert int(((idx == 0) & (tmin < BIG)).sum()) >= 10
    c = torch.from_numpy(arrays["centers"]).double()[idx] - o.double()
    h = (d.double() * c).sum(-1)
    r = torch.from_numpy(arrays["radii"]).double()[idx]
    disc = h * h - (d.double() ** 2).sum(-1) * ((c * c).sum(-1) - r * r)
    assert int(((tmin < BIG) & (disc < 1e-3 * h * h)).sum()) >= 10


@pytest.mark.parametrize("group", GROUPS)
def test_group_sweep_matches_closest_hit(setup, group):
    """K11 on the group schedule: t and idx equal closest_hit_plain's bit for
    bit; the tests with disc >= 0 those of the sweep of one thread per ray;
    G x ceil(n / G) slot-test lanes a ray."""
    _, _, sph, o, d = setup
    t, idx, n = ck.group_sweep_plain(o, d, sph, group)
    near = torch.zeros(1, dtype=torch.int64)
    t_p, idx_p = ik.closest_hit_plain(o, d, sph, stats=near)
    assert torch.equal(t, t_p)
    assert torch.equal(idx, idx_p)
    r = o.shape[0]
    _, ok = _sweep(o, d, sph)
    assert n["near"] == int(near) == int(ok.sum())
    assert (n["admitted"], n["tests"], n["bound_tests"]) == (r, r * N, 0)
    assert n["issued"] == r * group * -(-N // group)


@pytest.mark.parametrize("group", GROUPS)
def test_group_sweep_matches_fused_bounce(setup, group):
    """K10 on the group schedule, every third lane inactive (an inactive
    lane is swept all the same): the winner and hit of fused_bounce_plain
    bit for bit, and its four counters (lanes, one sweep a lane, n tests a
    lane, tests with disc >= 0)."""
    _, scene, sph, o, d = setup
    r = o.shape[0]
    act = torch.arange(r) % 3 != 2
    rid = torch.arange(r, dtype=torch.int32) * 7 + 13
    stats = torch.zeros(4, dtype=torch.int64)
    out = bk.fused_bounce_plain(o, d, act, rid, bk.fused_scene_arrays(scene), 1357, stats=stats)
    t, idx, n = ck.group_sweep_plain(o, d, sph, group)
    assert torch.equal(idx, out.idx)
    assert torch.equal(t < BIG * 0.5, out.hit)
    assert stats.tolist() == [r, n["admitted"], n["tests"], n["near"]]


def test_tie_scene_matches_jax_interpret(setup, jax_tie):
    """The tie scene through JAX's K11 in interpret mode, on the rays that
    graze no sphere (every ray at the twins among them): idx and hit equal
    the model's (the lower twin wins the exact ties there too), t within
    the band of the module docstring."""
    arrays, _, sph, o, d = setup
    t, idx, _ = ck.group_sweep_plain(o, d, sph, 32)
    oc = torch.from_numpy(arrays["centers"]).double()[None] - o.double()[:, None]
    h = (d.double()[:, None] * oc).sum(-1)
    r = torch.from_numpy(arrays["radii"]).double()
    a = (d.double() ** 2).sum(-1)[:, None]
    disc = h * h - a * ((oc * oc).sum(-1) - r * r)
    calm = ~((disc.abs() < 1e-6 * (h * h + a * (oc * oc).sum(-1))) & (r > 0)).any(1)
    twin = idx == TWINS[0]
    assert int(twin.sum()) >= 10 and not bool((idx == TWINS[1]).any())
    assert bool(calm[twin].all()) and int(calm.sum()) >= 0.8 * o.shape[0]
    calm = calm.numpy()
    hit = np.asarray(jax_tie.hit)
    np.testing.assert_array_equal((t < BIG * 0.5).numpy()[calm], hit[calm])
    np.testing.assert_array_equal(idx.numpy()[calm], np.asarray(jax_tie.idx)[calm])
    win = (torch.arange(o.shape[0]), idx.long())  # the float64 root on the winner
    sq = torch.sqrt(torch.clamp_min(disc[win], 0.0))
    root = (h[win] - sq) / a[:, 0]
    t64 = torch.where(root > 1e-3, root, (h[win] + sq) / a[:, 0]).numpy()
    for got in (t.numpy(), np.asarray(jax_tie.t)):
        assert (np.abs(got - t64) / t64)[calm & hit].max() < 2e-3
