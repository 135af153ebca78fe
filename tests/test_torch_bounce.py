"""The port's plain sweep and shading against the JAX bodies
(_sweep_winner, _shade_vals) on the same seeded ray rows and draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from distributed_raytracer_tpu.ops.pallas.bounce_kernel import (
    _auto_chunk,
    _shade_vals,
    _sweep_winner,
)
from distributed_raytracer_tpu.ops.pallas.culled_bounce_kernel import _hash_u01
from distributed_raytracer_tpu.ops.pallas.mega_kernel import scene_sweep_arrays as jax_sweep_arrays
from distributed_raytracer_tpu_torch.ops.kernels.bounce import (
    A_IDX,
    A_MT,
    scene_sweep_arrays,
    shade_vals,
    sweep_winner,
)
from test_torch_scene import to_port

torch.set_num_threads(1)
BIG = 1e30


def _rays(scene, rng, n, origin_lo, origin_hi, miss_share=0.1):
    """Seeded f32 ray rows: origins in a box, directions at random points
    near random sphere centers, a share pointing straight up."""
    o = rng.uniform(origin_lo, origin_hi, (n, 3)).astype(np.float32)
    centers = np.asarray(scene.centers)
    radii = np.asarray(scene.radii)
    live = np.flatnonzero(radii > 0)
    k = rng.choice(live, n)
    target = centers[k] + rng.normal(0, 1, (n, 3)) * np.minimum(radii[k], 1.0)[:, None]
    d = (target - o).astype(np.float32)
    up = rng.random(n) < miss_share
    d[up] = np.array([0.01, 1.0, 0.02], np.float32)
    return o, d


def _jax_sweep(scene, o, d):
    a = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]).astype(np.float32)
    inv_a = (np.float32(1.0) / a).astype(np.float32)
    row = lambda x: jnp.asarray(x.reshape(1, -1))
    cols, attrs = jax_sweep_arrays(scene, _auto_chunk(scene.num_spheres))
    t_c, wa = _sweep_winner(row(o[:, 0]), row(o[:, 1]), row(o[:, 2]),
                            row(d[:, 0]), row(d[:, 1]), row(d[:, 2]),
                            row(a), row(inv_a), *cols, attrs)
    return a, inv_a, np.asarray(t_c)[0], np.asarray(wa)


def _port_sweep(scene, o, d, a, inv_a):
    cols, attrs = scene_sweep_arrays(to_port(scene))
    T = lambda x: torch.from_numpy(np.array(x))
    t, w = sweep_winner(T(o[:, 0]), T(o[:, 1]), T(o[:, 2]), T(d[:, 0]), T(d[:, 1]),
                        T(d[:, 2]), T(a), T(inv_a), cols, attrs)
    return t.numpy(), w.numpy()


def _port_sweep_f64(scene, o, d):
    """The port's sweep t on the same f32 rays and scene, in float64."""
    cols, attrs = scene_sweep_arrays(to_port(scene))
    T = lambda x: torch.from_numpy(np.array(x)).double()
    dx, dy, dz = T(d[:, 0]), T(d[:, 1]), T(d[:, 2])
    a = dx * dx + dy * dy + dz * dz
    t, _ = sweep_winner(T(o[:, 0]), T(o[:, 1]), T(o[:, 2]), dx, dy, dz, a, 1.0 / a,
                        cols.double(), attrs.double())
    return t.numpy()


# the port's ground-sphere t against float64: measured 4.02e-5 (config2)
# and 8.95e-5 (final) relative, where float64 takes the same root
GROUND_F64_RTOL = 1.5e-4


@pytest.mark.parametrize("which", ["config2", "final"])
def test_sweep_winner_matches_jax(which):
    rng = np.random.default_rng(11)
    if which == "config2":
        scene = jp.get_config("config2")[0]
        o, d = _rays(scene, rng, 2048, (-2.0, -0.3, 0.0), (2.0, 1.0, 2.0))
    else:
        scene = jp.rtiow_final_scene(pad_to=512)
        o, d = _rays(scene, rng, 2048, (11.0, 1.0, 1.0), (14.0, 3.0, 5.0))
    a, inv_a, t_j, wa = _jax_sweep(scene, o, d)
    t_t, w_t = _port_sweep(scene, o, d, a, inv_a)
    hit = t_j < BIG * 0.5
    assert 0.3 < hit.mean() < 0.97  # both hits and misses are exercised
    np.testing.assert_array_equal(w_t[A_IDX], wa[A_IDX])
    # On the ground sphere (R = 100 or 1000) c_q = |oc|^2 - r^2 cancels:
    # one f32 ulp of |oc|^2 is 1e-5..0.06, so two correct evaluations that
    # contract differently into FMAs differ there by ~1e-5 relative in t,
    # and both stand up to 5e-5 (config2) and 9e-5 (final) from the same
    # sweep in float64.  Those rays get rtol 3e-5 against JAX, except where
    # JAX's own t is more than 3e-5 from float64 (its rounding there
    # depends on the host's XLA:CPU code: 6 of 779 config2 ground rays, up
    # to 5.0e-5, on an AVX-512 host), and every ground ray is held to
    # float64 at GROUND_F64_RTOL.  Every other sphere is held to rtol 1e-6.
    ground = np.asarray(scene.radii)[wa[A_IDX].astype(int)] >= 100.0
    np.testing.assert_allclose(t_t[~ground], t_j[~ground], rtol=1e-6, atol=0)
    t_64 = _port_sweep_f64(scene, o, d)
    d_port, d_jax = (np.abs(t.astype(np.float64) - t_64) / t_64 for t in (t_t, t_j))
    # a ray that float64 sends to another root or sphere (1 on the final
    # scene's ground): both f32 sweeps take the same one
    same_branch = d_jax < 1e-3
    excused = ground & same_branch & (d_jax > 3e-5)
    print(f"{which} ground: port-f64 {d_port[ground & same_branch].max():.3g}, jax-f64 "
          f"{d_jax[ground & same_branch].max():.3g}, port-jax "
          f"{(np.abs(t_t - t_j) / t_j)[ground].max():.3g}; "
          f"{int((ground & ~same_branch).sum())} other-branch, {int(excused.sum())} excused")
    assert d_port[ground & same_branch].max() < GROUND_F64_RTOL
    keep = ground & ~excused
    np.testing.assert_allclose(t_t[keep], t_j[keep], rtol=3e-5, atol=0)
    # the gathered attributes equal the MXU-selected ones exactly
    np.testing.assert_array_equal(w_t, wa[:w_t.shape[0]])


def _material_scene():
    return (JaxSceneBuilder()
            .add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
            .add_lambertian((0.0, 0.0, -1.2), 0.5, (0.1, 0.2, 0.5))
            .add_dielectric((-1.0, 0.0, -1.0), 0.5, 1.5)
            .add_metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.3)
            .add_absorbing((0.0, 1.2, -1.0), 0.4)
            .add_transparent((0.3, -0.2, 0.4), 0.3)
            .build())


def test_shade_vals_matches_jax():
    scene = _material_scene()
    rng = np.random.default_rng(5)
    n = 4096
    o, d = _rays(scene, rng, n, (-1.5, -0.3, 0.8), (1.5, 1.5, 2.5), miss_share=0.1)
    # an eighth of the rays start inside the glass sphere: back-face hits
    inside = rng.random(n) < 0.125
    o[inside] = (np.array([-1.0, 0.0, -1.0]) + rng.uniform(-0.2, 0.2, (inside.sum(), 3))
                 ).astype(np.float32)
    d[inside] = rng.normal(0, 1, (inside.sum(), 3)).astype(np.float32)
    a, _, t_j, wa = _jax_sweep(scene, o, d)
    act = rng.random(n) < 0.9
    rid = np.arange(n, dtype=np.int32) + 1000
    draws = [np.asarray(_hash_u01(jnp.asarray(rid), jnp.int32(777), k)) for k in range(5)]

    row = lambda x: jnp.asarray(x.reshape(1, -1))
    want = _shade_vals(row(o[:, 0]), row(o[:, 1]), row(o[:, 2]),
                       row(d[:, 0]), row(d[:, 1]), row(d[:, 2]), row(a), row(act),
                       row(t_j), jnp.asarray(wa), draws=tuple(row(x) for x in draws))
    want = [np.asarray(x)[0] for x in want]
    T = lambda x: torch.from_numpy(np.array(x))
    got = shade_vals(T(o[:, 0]), T(o[:, 1]), T(o[:, 2]), T(d[:, 0]), T(d[:, 1]),
                     T(d[:, 2]), T(a), T(act), T(t_j), T(wa), tuple(T(x) for x in draws))
    got = [x.numpy() for x in got]

    # coverage: all five materials hit, front and back faces, misses
    hit = (t_j < BIG * 0.5) & act
    mats = set(wa[A_MT][hit].astype(int).tolist())
    assert mats == {0, 1, 2, 3, 4}, mats
    px = o + np.where(hit, t_j, 1.0)[:, None] * d
    ctr = np.stack([wa[0], wa[1], wa[2]], -1)
    front = np.sum(d * (px - ctr), -1) < 0
    assert (hit & front).any() and (hit & ~front).any()
    assert (act & ~hit).any()

    np.testing.assert_array_equal(got[12], want[12])   # fin
    np.testing.assert_array_equal(got[13], want[13])   # winner index
    for k in list(range(12)) + [14, 15, 16, 17]:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=f"row {k}")
