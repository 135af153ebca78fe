"""The port's closest hits against the JAX package's, on the CPU:
ops/intersect.py::closest_hit (the dense expanded form) against JAX's at
test_intersect.py's cases; K11's plain version (closest_hit_plain, the oc
form) against JAX's closest_hit_pallas in interpret mode at
test_pallas_kernel.py's shapes, and its winner-only backward against
JAX's custom VJP and against autograd of the plain closest hit;
block_visit_plan against JAX's _block_visit_plan; the plain K12/K13
against JAX's make_culled_intersect in both modes at test_culled.py's
shapes.  JAX's interpret kernels run once per module.

idx and hit are held equal.  t is held within 1e-5 relative, and on hits
of the R = 1000 ground sphere within 1e-4: there |oc|^2 - r^2 cancels at
|oc|^2 ~ 1e6, and XLA:CPU and torch round it apart (measured 6.4e-6 off
the ground, 7.1e-5 on it, at 512 rays on the final scene), while both
stand 9.7e-4 from the float64 root on the same ground hits (the referee
below).  The two closest hits, expanded and oc form, are held to each
other at JAX's own band (test_pallas_kernel.py: idx and hit equal where
hit, t within 3e-3 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.models.presets import random_sphere_field, rtiow_final_scene
from distributed_raytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from distributed_raytracer_tpu.ops.intersect import closest_hit as jax_closest_hit
from distributed_raytracer_tpu.ops.pallas import culled_kernel as jck
from distributed_raytracer_tpu.ops.pallas.intersect_kernel import closest_hit_pallas as jax_k11
from distributed_raytracer_tpu_torch.core.vecmath import BIG
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit
from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
from test_torch_scene import to_port

torch.set_num_threads(1)
GROUND = 100.0  # radius above which a sphere is the ground


def _rays(seed, n, extent):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-extent, extent, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _hold(got, want, radii, rel=1e-5, rel_ground=1e-4):
    """idx and hit equal, t within rel (rel_ground on ground hits)."""
    h = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), h)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    idx = got.idx.numpy()
    ground = h & (radii[idx] > GROUND)
    jt, tt = np.asarray(want.t), got.t.numpy()
    err = np.abs(tt - jt) / np.where(h, jt, 1.0)
    assert err[h & ~ground].max(initial=0.0) < rel
    assert err[ground].max(initial=0.0) < rel_ground
    np.testing.assert_array_equal(tt[~h], np.full((~h).sum(), BIG, np.float32))


@pytest.fixture(scope="module")
def final_k11():
    """512 rays on the padded final scene, through JAX's K11 in interpret
    mode (test_pallas_kernel.py's fixture)."""
    scene = rtiow_final_scene(seed=0, pad_to=512)
    o, d = _rays(0, 512, 8.0)
    with pltpu.force_tpu_interpret_mode():
        want = jax_k11(jnp.asarray(o), jnp.asarray(d), scene)
    return scene, o, d, want


@pytest.fixture(scope="module")
def culled_runs():
    """JAX's culled intersect in both modes at test_culled.py's two shapes."""
    runs = {}
    for name, scene, n, extent, seed in (
            ("final", rtiow_final_scene(seed=0), 512, 8.0, 0),
            ("field", random_sphere_field(1000, seed=2), 256, 40.0, 1)):
        culled = jck.build_culled_scene(scene, chunk=128)
        o, d = _rays(seed, n, extent)
        want = {}
        for mode in ("grid", "walk"):
            with pltpu.force_tpu_interpret_mode():
                want[mode] = jck.make_culled_intersect(culled, mode=mode)(
                    jnp.asarray(o), jnp.asarray(d), culled.scene)
        runs[name] = (scene, culled, o, d, want)
    return runs


def _unit_sphere():
    return JSceneBuilder().add_lambertian((0.0, 0.0, -2.0), 1.0, (0.5, 0.5, 0.5)).build()


CASES = {  # test_intersect.py's cases: (scene, o, d)
    "head_on": (_unit_sphere(), [[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]]),
    "inside": (_unit_sphere(), [[0.0, 0.0, -2.0]], [[0.0, 0.0, -1.0]]),
    "miss": (_unit_sphere(), [[0.0, 5.0, 0.0]], [[0.0, 0.0, -1.0]]),
    "t_min": (_unit_sphere(), [[0.0, 0.0, -1.0]], [[0.0, 0.0, -1.0]]),
    "unnormalized": (_unit_sphere(), [[0.0, 0.0, 0.0]], [[0.0, 0.0, -4.0]]),
    "closest_of_many": (JSceneBuilder().add_lambertian((0.0, 0.0, -10.0), 1.0, (0.5,) * 3)
                        .add_lambertian((0.0, 0.0, -4.0), 1.0, (0.5,) * 3)
                        .add_lambertian((0.0, 0.0, -7.0), 1.0, (0.5,) * 3).build(),
                        [[0.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]]),
}


def _random_case():
    rng = np.random.default_rng(3)
    b = JSceneBuilder()
    for c, r in zip(rng.uniform(-5, 5, (16, 3)), rng.uniform(0.3, 2.0, 16)):
        b.add_lambertian(c, r, (0.5, 0.5, 0.5))
    o = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    return b.build(), o, d


def _padded_case():
    rng = np.random.default_rng(5)
    scene = JSceneBuilder().add_lambertian((0.0, 0.0, -2.0), 1.0, (0.5,) * 3).build(pad_to=128)
    return (scene, rng.uniform(-5, 5, (128, 3)).astype(np.float32),
            rng.normal(size=(128, 3)).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES) + ["random", "padded"])
def test_closest_hit_matches_jax(case):
    if case == "random":
        scene, o, d = _random_case()
    elif case == "padded":
        scene, o, d = _padded_case()
    else:
        scene, o, d = CASES[case]
    o, d = np.asarray(o, np.float32), np.asarray(d, np.float32)
    want = jax_closest_hit(jnp.asarray(o), jnp.asarray(d), scene)
    got = closest_hit(torch.from_numpy(o), torch.from_numpy(d), to_port(scene))
    _hold(got, want, np.asarray(scene.radii))


def test_k11_plain_matches_jax_interpret(final_k11):
    scene, o, d, want = final_k11
    got = ik.closest_hit_pallas(torch.from_numpy(o), torch.from_numpy(d), to_port(scene))
    _hold(got, want, np.asarray(scene.radii))
    # the float64 root on the winner: JAX and the port stand as far from it
    # on the ground hits, where the rounding of the cancellation parts them
    h, idx = got.hit.numpy(), got.idx.numpy()
    c = np.asarray(scene.centers, np.float64)[idx]
    r = np.asarray(scene.radii, np.float64)[idx]
    od, dd = o.astype(np.float64), d.astype(np.float64)
    oc = c - od
    a, hb = (dd * dd).sum(-1), (dd * oc).sum(-1)
    sq = np.sqrt(np.maximum(hb * hb - a * ((oc * oc).sum(-1) - r * r), 0.0))
    t64 = np.where((hb - sq) / a > 1e-3, (hb - sq) / a, (hb + sq) / a)
    for t in (got.t.numpy(), np.asarray(want.t)):
        assert (np.abs(t - t64) / t64)[h].max() < 2e-3


def test_k11_plain_ragged_rays_unpadded_scene():
    scene = (JSceneBuilder().add_lambertian((0, 0, -2), 1.0, (0.5, 0.5, 0.5))
             .add_metal((2, 0, -3), 0.7, (0.8, 0.8, 0.8), 0.1).build())
    rng = np.random.default_rng(1)
    o = rng.uniform(-3, 3, (77, 3)).astype(np.float32)
    d = rng.normal(size=(77, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_k11(jnp.asarray(o), jnp.asarray(d), scene)
    got = ik.closest_hit_pallas(torch.from_numpy(o), torch.from_numpy(d), to_port(scene))
    _hold(got, want, np.asarray(scene.radii))


def test_dense_forms_agree_at_jax_band(final_k11):
    scene, o, d, _ = final_k11
    ts = to_port(scene)
    dense = closest_hit(torch.from_numpy(o), torch.from_numpy(d), ts)
    k11 = ik.closest_hit_pallas(torch.from_numpy(o), torch.from_numpy(d), ts)
    h = dense.hit.numpy()
    np.testing.assert_array_equal(k11.hit.numpy(), h)
    np.testing.assert_array_equal(k11.idx.numpy()[h], dense.idx.numpy()[h])
    np.testing.assert_allclose(k11.t.numpy()[h], dense.t.numpy()[h], rtol=3e-3)


def _loss_grads(fn, scene, o, d):
    c = scene.centers.clone().requires_grad_()
    r = scene.radii.clone().requires_grad_()
    oo = torch.from_numpy(o).requires_grad_()
    dd = torch.from_numpy(d).requires_grad_()
    res = fn(oo, dd, scene.with_diff_params(dict(centers=c, radii=r)))
    torch.where(res.hit, res.t, 0.0).sum().backward()
    return [x.grad.numpy() for x in (c, r, oo, dd)]


def test_k11_backward_matches_jax_and_autograd(final_k11):
    scene, o, d, _ = final_k11
    ts = to_port(scene)

    def jax_loss(c, rr, oo, dd):
        with pltpu.force_tpu_interpret_mode():
            res = jax_k11(oo, dd, scene.replace(centers=c, radii=rr))
        return jnp.sum(jnp.where(res.hit, res.t, 0.0))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(scene.centers, scene.radii,
                                                  jnp.asarray(o), jnp.asarray(d))
    got = _loss_grads(ik.closest_hit_pallas, ts, o, d)
    auto = _loss_grads(closest_hit, ts, o, d)
    for g, w, a, name in zip(got, want, auto, ("centers", "radii", "ray_o", "ray_d")):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-6
        # the same winner-only VJP: equal to rounding
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-5, err_msg=name)
        # autograd through the dense expanded form (test_pallas_kernel.py's band)
        np.testing.assert_allclose(g / scale, a / scale, rtol=0, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("name", ["final", "field"])
def test_block_visit_plan_matches_jax(culled_runs, name):
    scene, culled, o, d, _ = culled_runs[name]
    tcs = ck.build_culled_scene(to_port(scene), chunk=128)
    br, nb = ck.plan_blocks(o.shape[0])
    want = jck._block_visit_plan(jnp.asarray(o), jnp.asarray(d), culled.bounds_c,
                                 culled.bounds_r2, nb, br)
    got = ck.block_visit_plan(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(tcs.bounds_c), torch.from_numpy(tcs.bounds_r2),
                              nb, br)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("mode", ["grid", "walk"])
@pytest.mark.parametrize("name", ["final", "field"])
def test_culled_plain_matches_jax_interpret(culled_runs, name, mode):
    scene, culled, o, d, want = culled_runs[name]
    tcs = ck.build_culled_scene(to_port(scene), chunk=128)
    np.testing.assert_array_equal(tcs.order, culled.order)
    fn = ck.make_culled_intersect(tcs, mode=mode)
    got = fn(torch.from_numpy(o), torch.from_numpy(d), tcs.scene)
    _hold(got, want[mode], tcs.scene.radii.numpy())
    # and the dense K11 on the culled scene: the same winners
    dense = ik.closest_hit_pallas(torch.from_numpy(o), torch.from_numpy(d), tcs.scene)
    np.testing.assert_array_equal(got.idx.numpy(), dense.idx.numpy())
    np.testing.assert_array_equal(got.t.numpy(), dense.t.numpy())


def test_culled_backward_is_k11s(culled_runs):
    scene, culled, o, d, _ = culled_runs["final"]
    tcs = ck.build_culled_scene(to_port(scene), chunk=128)
    got = _loss_grads(ck.make_culled_intersect(tcs), tcs.scene, o, d)
    want = _loss_grads(ik.closest_hit_pallas, tcs.scene, o, d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
