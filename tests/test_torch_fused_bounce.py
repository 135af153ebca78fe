"""The port's fused bounce (K10, plain version on the CPU) against the JAX
package's fused_bounce (ops/pallas/bounce_kernel.py) in interpret mode.

JAX's kernel draws from pltpu.prng_random_bits, which gives zeros in
interpret mode, so all five of its uniforms are clip(0) = 1e-7 there; the
port is handed those five uniforms through draws=.  The cases are
tests/test_fused_bounce.py's (miss -> sky, absorb -> black, the winner
across sphere chunks, inactive lanes untouched), held at: integer
outputs equal, float outputs within 1e-6.

Two more scenes carry rays through every material: the RTiOW final scene
(512 spheres, the kernel's shared-memory path) and a 601-sphere field
(its global-memory path; JAX sweeps it in two chunks of 512).  There the
next origin and direction of a scattered ray depend on the sweep's t,
which XLA:CPU (contracting products into FMAs) and torch (rounding each
operation) round differently: where the ray grazes a sphere (disc < 1e-3
h^2) one rounding moves it far, and the two stand 1.5e-4 (origin) and
2.3e-3 (direction) apart on the final scene, 2.3e-3 and 5.7e-3 on the
field.  Both are held to the same bounce in float64 at the bands JAX
holds its own kernel to its oracle (test_culled_fused.py:83-93: 2e-3 for
the origin, 8e-3 for the direction; measured port 1.0e-3 and 1.9e-3, JAX
1.6e-3 and 3.8e-3), and the port to JAX at 1e-3 on the rays without a
grazing hit (measured 1.6e-4); every other output as above."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from distributed_raytracer_tpu.ops.pallas.bounce_kernel import fused_bounce as jax_fused_bounce
from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
from test_torch_scene import to_port

torch.set_num_threads(1)
FIELDS = ("new_o", "new_d", "atten", "color", "finished", "idx", "hit", "ruv", "u")


def _tile(n, v):
    return np.tile(np.asarray([v], np.float32), (n, 1))


def _rays(n, seed, center=(13.0, 2.0, 3.0), spread=0.1):
    """test_culled_fused.py:_rays's shape, from numpy: origins around
    center, directions toward the origin plus noise."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 2 + np.asarray(center)).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    return o, (d + spread * rng.normal(size=(n, 3))).astype(np.float32)


def _jax(scene, o, d, act, seed):
    with pltpu.force_tpu_interpret_mode():
        out = jax_fused_bounce(jnp.asarray(o), jnp.asarray(d), jnp.asarray(act), scene,
                               jnp.int32(seed))
    return {k: np.asarray(getattr(out, k)) for k in FIELDS}


def _port(scene, o, d, act, seed, dtype=torch.float32):
    """The port's bounce with JAX's interpret-mode draws, in dtype."""
    r = o.shape[0]
    draws = [torch.full((r,), 1e-7, dtype=dtype)] * 5
    arrays = [x.to(dtype) for x in bk.fused_scene_arrays(to_port(scene))]
    out = bk.fused_bounce(torch.from_numpy(o).to(dtype), torch.from_numpy(d).to(dtype),
                          torch.from_numpy(act), torch.arange(r, dtype=torch.int32), arrays,
                          seed, draws=draws)
    return {k: getattr(out, k).numpy() for k in FIELDS}


def _assert_matches(got, want, fields=FIELDS):
    for k in fields:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def _grazing(scene, o, d, idx, hit):
    """[R] bool: the rays whose hit has disc < 1e-3 h^2 (float64)."""
    c = np.asarray(scene.centers, np.float64)[idx] - o
    r = np.asarray(scene.radii, np.float64)[idx]
    d = d.astype(np.float64)
    h = (d * c).sum(-1)
    disc = h * h - (d * d).sum(-1) * ((c * c).sum(-1) - r * r)
    return hit & (disc < 1e-3 * h * h)


def _chunked_scene():
    """test_fused_bounce.py:47-68: a transparent sphere in front and an
    absorbing one behind, in another sphere chunk."""
    b = JaxSceneBuilder()
    b.add_transparent((0, 0, -2), 0.5)
    for i in range(140):
        b.add_absorbing((1000 + i, 0, 0), 0.1)
    b.add_absorbing((0, 0, -10), 0.5)
    return b.build()


CASES = {
    "miss-sky": (lambda: JaxSceneBuilder().add_lambertian((0, 0, 1000.0), 1.0,
                                                          (0.5, 0.5, 0.5)).build(),
                 256, (0.0, 0.3, -1.0), True),
    "absorb-black": (lambda: JaxSceneBuilder().add_absorbing((0, 0, -2), 1.0).build(),
                     128, (0.0, 0.0, -1.0), True),
    "winner-across-chunks": (_chunked_scene, 128, (0.0, 0.0, -1.0), True),
    "inactive-untouched": (lambda: JaxSceneBuilder().add_lambertian((0, 0, -2), 1.0,
                                                                    (0.5, 0.5, 0.5)).build(),
                           128, (0.0, 0.0, -1.0), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cases_match_jax_interpret(case):
    make, n, direction, active = CASES[case]
    scene = make()
    o, d = np.zeros((n, 3), np.float32), _tile(n, direction)
    act = np.full((n,), active)
    want = _jax(scene, o, d, act, 1)
    got = _port(scene, o, d, act, 1)
    _assert_matches(got, want)
    if case == "miss-sky":
        assert (got["finished"] == 1).all() and not got["hit"].any()
        assert (got["color"][:, 2] > got["color"][:, 0]).all()
    elif case == "absorb-black":
        assert (got["finished"] == 1).all() and (got["color"] == 0).all()
    elif case == "winner-across-chunks":  # the transparent sphere (index 0) won
        assert (got["finished"] == 0).all() and (got["idx"] == 0).all()
        np.testing.assert_array_equal(got["new_o"], o)
        np.testing.assert_array_equal(got["new_d"], d)
    else:
        assert (got["finished"] == 0).all() and got["hit"].all()
        np.testing.assert_array_equal(got["new_o"], o)
        np.testing.assert_array_equal(got["new_d"], d)
        np.testing.assert_array_equal(got["atten"], 1.0)
        np.testing.assert_array_equal(got["color"], 0.0)


@pytest.mark.parametrize("which", ["final512", "field600"])
def test_scenes_match_jax_interpret(which):
    """Mixed materials, every third lane inactive: the final scene (512
    spheres, the kernel's shared-memory path) and a 601-sphere field (its
    global-memory path)."""
    if which == "final512":
        scene, (o, d) = jp.rtiow_final_scene(seed=0, pad_to=512), _rays(384, 3)
    else:
        scene = jp.random_sphere_field(600, seed=7, extent=12.0)
        o, d = _rays(384, 4, center=(0.0, 6.0, 25.0), spread=0.3)
    act = np.arange(o.shape[0]) % 3 != 2
    got, want = _port(scene, o, d, act, 5), _jax(scene, o, d, act, 5)
    exact = _port(scene, o, d, act, 5, dtype=torch.float64)
    _assert_matches(got, want, ("atten", "color", "finished", "idx", "hit", "ruv", "u"))
    assert got["hit"].mean() > 0.5 and len(np.unique(got["idx"][got["hit"]])) > 10
    scattered = act & (got["finished"] == 0)
    calm = ~_grazing(scene, o, d, want["idx"], want["hit"])
    assert 0.2 < scattered.mean() and calm.mean() > 0.5
    for k, band in (("new_o", 2e-3), ("new_d", 8e-3)):
        # a ray that did not scatter passes through unchanged
        np.testing.assert_array_equal(got[k][~scattered], want[k][~scattered])
        assert np.abs(got[k] - exact[k]).max() < band, k
        assert np.abs(want[k] - exact[k]).max() < band, k
        assert np.abs(got[k] - want[k])[calm].max() < 1e-3, k


def test_hash_draws_and_counters():
    """Without draws= the bounce draws hash_u01(ray_id, seed, 0..4) (the
    keys of the culled fused bounce), and the counters count the lanes,
    one chunk of n sphere tests per lane, and the tests with disc >= 0."""
    from distributed_raytracer_tpu_torch.ops.kernels.hash import hash_u01

    scene = to_port(jp.rtiow_final_scene(seed=0, pad_to=512))
    o, d = (torch.from_numpy(x) for x in _rays(64, 9))
    rid = torch.arange(64, dtype=torch.int32) * 7 + 13
    act = torch.ones(64, dtype=torch.bool)
    stats = torch.zeros(4, dtype=torch.int64)
    arrays = bk.fused_scene_arrays(scene)
    out = bk.fused_bounce(o, d, act, rid, arrays, 24680, stats=stats)
    draws = [hash_u01(rid, 24680, k) for k in range(5)]
    given = bk.fused_bounce(o, d, act, rid, arrays, 24680, draws=draws)
    for k in FIELDS:
        assert torch.equal(getattr(out, k), getattr(given, k)), k
    assert torch.equal(out.u, draws[4])
    lanes, chunks, tests, near = stats.tolist()
    assert (lanes, chunks, tests) == (64, 64, 64 * 512) and 0 < near < tests


def test_cuda_wrapper_rejects_cpu_tensors():
    scene = to_port(jp.rtiow_final_scene(seed=0, pad_to=512))
    o, d = (torch.from_numpy(x) for x in _rays(8, 1))
    before = bk.fused_bounce_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        bk.fused_bounce_cuda(o, d, torch.ones(8, dtype=torch.bool),
                             torch.arange(8, dtype=torch.int32), bk.fused_scene_arrays(scene), 1)
    assert bk.fused_bounce_cuda.launches == before
