"""The port's fused wavefront engine (plain versions, CPU) against the JAX
package's culled render_wavefront_sum_fused in interpret mode, and the
properties its draw keying gives it.

Against JAX (tests/test_culled_fused.py:194-217's shape: config1, 24 wide,
depth 8, 2 spp, pool 256, chunks of 128), fed the seeds JAX derives from
its key: JAX's interpret engine parts from the same engine run in float64
on 18 of 5,400 pixels (up to 0.34 a sample: a path that XLA:CPU's
rounding sends another way), the port on 4 (measured on one host; how
XLA:CPU rounds depends on the host).  So the port is held at the depth-8
band (max < 5e-4, mean < 5e-6 a sample) to JAX on every pixel where JAX
stands within that band of float64 (measured 1.2e-7 and 5.6e-9), and to
float64 on 99% of the pixels.

Properties, bit for bit: the dense and culled engines give equal sums on
the same scene (K14 walks the culled scene's chunks in its own order, so
its winner is the dense argmin); with a pool that holds every ray, the
engine equals the mega engine (dense) and the walk (culled) at the same
two seeds; a lane re-sort changes nothing, and a pixel_perm render read
back through the permutation is the pixel_ids render of it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.ops.pallas.culled_kernel import build_culled_scene as jax_culled
from distributed_raytracer_tpu.render import order as jorder
from distributed_raytracer_tpu.render import wavefront as jwf
from distributed_raytracer_tpu_torch import cli
from distributed_raytracer_tpu_torch.models import presets as tp
from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import build_culled_scene
from distributed_raytracer_tpu_torch.render import order, progressive, wavefront
from distributed_raytracer_tpu_torch.render.image import read_ppm
from test_torch_scene import to_port

torch.set_num_threads(1)
BS, CS = 123456, 987654


def _f64(scene):
    return dataclasses.replace(scene, **{k: getattr(scene, k).double() for k in
                                         ("centers", "radii", "albedo", "fuzz", "ior")})


@pytest.fixture(scope="module")
def config1_run():
    scene, cam = jp.get_config("config1")
    cam = cam.replace(image_width=24, max_depth=8)
    key = jax.random.PRNGKey(7)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jwf.render_wavefront_sum_fused(
            scene, cam, key, spp=2, pool_size=256, culled=jax_culled(scene, chunk=128)))
    # the seeds the JAX engine derives from its key (wavefront.py:305-323)
    bs = int(jax.random.randint(key, (), 0, 2**31 - 1))
    cs = int(jax.random.randint(jax.random.fold_in(key, 0xCA3), (), 0, 2**31 - 1))
    ts, tc = to_port(scene, cam)
    return want, ts, tc, build_culled_scene(ts, chunk=128), bs, cs


def test_culled_engine_matches_jax_interpret(config1_run):
    want, ts, tc, culled, bs, cs = config1_run
    kw = dict(pool_size=256, device="cpu")
    got = wavefront.render_wavefront_sum_fused(ts, tc, 2, bs, cs, culled=culled, **kw).numpy()
    exact = wavefront.render_wavefront_sum_fused(
        _f64(ts), tc, 2, bs, cs, culled=culled._replace(scene=_f64(culled.scene)), **kw).numpy()
    assert got.shape == (tc.num_pixels, 3) and np.isfinite(got).all()
    d = np.abs(got - want) / 2
    jax_ok = np.abs(want - exact).max(axis=1) / 2 <= 5e-4
    assert jax_ok.mean() >= 0.98, (~jax_ok).sum()
    assert d[jax_ok].max() < 5e-4, d[jax_ok].max()
    assert d[jax_ok].mean() < 5e-6, d[jax_ok].mean()
    port_ok = np.abs(got - exact).max(axis=1) / 2 <= 5e-4
    assert port_ok.mean() >= 0.99, (~port_ok).sum()


@pytest.fixture(scope="module")
def final():
    scene = tp.rtiow_final_scene(seed=0, pad_to=512)
    camera = tp.final_scene_camera(32).replace(max_depth=8)
    return scene, camera, build_culled_scene(scene, chunk=128)


def _fused(scene, camera, spp=2, **kw):
    return wavefront.render_wavefront_sum_fused(scene, camera, spp, BS, CS, device="cpu", **kw)


def test_full_pool_equals_mega_engine(final):
    """A pool holding every ray: each ray's iteration is its depth, so the
    dense engine is render_wavefront_sum_mega (K5) and the culled one the
    walk over the culled scene (K9), bit for bit."""
    scene, camera, culled = final
    total = 2 * camera.num_pixels
    mega = mrk.render_wavefront_sum_mega(scene, camera, 2, BS, CS, device="cpu")
    assert torch.equal(_fused(scene, camera, pool_size=total), mega)
    walk = mwk.render_wavefront_sum_mega_walk(
        mwk.build_walk_pack(culled, camera.center.numpy()), camera, 2, BS, CS, device="cpu")
    assert torch.equal(_fused(scene, camera, pool_size=total, culled=culled), walk)
    assert torch.equal(walk, mega)


def test_dense_and_culled_engines_agree(final):
    """The same culled.scene traced densely (K10) and through the walk
    (K14) at a pool that refills: equal sums, and another noise than the
    full pool's (rays enter at later iterations)."""
    _, camera, culled = final
    dense = _fused(culled.scene, camera, pool_size=96)
    walked = _fused(culled.scene, camera, pool_size=96, culled=culled)
    assert torch.equal(dense, walked)
    assert not torch.equal(dense, _fused(culled.scene, camera, pool_size=2 * camera.num_pixels))


def test_resort_and_pixel_order(final):
    """A lane re-sort leaves the sums bit-identical; pixel_ids sums come in
    the order of the ids; a pixel_perm render comes back in pixel order,
    and read through the permutation it is the pixel_ids render of it."""
    scene, camera, culled = final
    kw = dict(pool_size=96, culled=culled)
    base = _fused(scene, camera, **kw)
    for every in (2, 3):
        assert torch.equal(_fused(scene, camera, resort_every=every, **kw), base)
    perm = order.tile_permutation(camera.image_width, camera.image_height, 8, 4)
    tiled = _fused(scene, camera, pixel_perm=perm, **kw)
    by_ids = _fused(scene, camera, pixel_ids=perm, **kw)
    assert torch.equal(tiled[torch.from_numpy(perm).long()], by_ids)
    assert torch.equal(_fused(scene, camera, pixel_ids=np.arange(camera.num_pixels), **kw), base)
    assert not torch.equal(tiled, base)  # the stream position keys the draws
    assert abs(float(tiled.mean() - base.mean())) < 0.05
    some = np.array([5, 3, 3, 500], np.int32)
    part = _fused(scene, camera, pixel_ids=some, **kw)
    assert part.shape == (4, 3) and torch.isfinite(part).all()


def test_argument_checks(final, monkeypatch):
    scene, camera, culled = final
    with pytest.raises(ValueError, match="requires culled"):
        _fused(scene, camera, resort_every=2)
    with pytest.raises(ValueError, match="exclude"):
        _fused(scene, camera, pixel_ids=np.arange(4), pixel_perm=np.arange(camera.num_pixels))
    # the engine runs on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wavefront.render_wavefront_sum_fused(scene, camera, 1, BS, CS, culled=culled)


def test_resort_permutation_and_tiles_match_jax():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(300, 3)).astype(np.float32) * 5
    d = rng.normal(size=(300, 3)).astype(np.float32)
    live = rng.random(300) < 0.7
    lo, hi = np.array([-9.0, -1.0, -9.0], np.float32), np.array([9.0, 3.0, 9.0], np.float32)
    want = np.asarray(jwf.warp_resort_permutation(jnp.asarray(o), jnp.asarray(d),
                                                  jnp.asarray(live), jnp.asarray(lo),
                                                  jnp.asarray(hi)))
    got = wavefront.warp_resort_permutation(*(torch.from_numpy(x) for x in (o, d, live, lo, hi)))
    np.testing.assert_array_equal(got.numpy(), want)
    for w, h in ((64, 32), (40, 20)):
        p = order.tile_permutation(w, h)
        np.testing.assert_array_equal(p, jorder.tile_permutation(w, h))
        np.testing.assert_array_equal(order.inverse_permutation(p),
                                      jorder.inverse_permutation(p))


def test_progressive_fused_resume_is_bit_identical(final, tmp_path):
    scene, camera, culled = final
    kw = dict(engine="fused", pool_size=128, device="cpu")
    ckw = dict(kw, culled=culled, ray_order="tiled", resort_every=2)
    whole = progressive.render_progressive(culled.scene, camera, seed=7, spp=4, batch=2, **ckw)
    assert whole.engine == "fused+culled"
    ckpt = str(tmp_path / "ck.npz")
    progressive.render_progressive(culled.scene, camera, seed=7, spp=2, batch=2,
                                   checkpoint_path=ckpt, **ckw)
    resumed = progressive.render_progressive(culled.scene, camera, seed=7, spp=4, batch=2,
                                             checkpoint_path=ckpt, **ckw)
    assert resumed.samples_done == 4
    np.testing.assert_array_equal(resumed.raw_sum, whole.raw_sum)
    # the dense engine's checkpoint is another engine's: started over
    dense = progressive.render_progressive(scene, camera, seed=7, spp=2, batch=2,
                                           checkpoint_path=ckpt, **kw)
    assert dense.engine == "fused" and dense.samples_done == 2
    want = wavefront.render_wavefront_sum_fused(scene, camera, 2, *progressive.batch_seeds(7, 0),
                                                pool_size=128, device="cpu")
    np.testing.assert_array_equal(dense.raw_sum, want.numpy())


def test_cli_fused_culled_cpu(tmp_path):
    out = str(tmp_path / "f.ppm")
    cli.main(["render", "--config", "config5", "--width", "32", "--spp", "2", "--engine",
              "fused", "--accel", "culled", "--resort", "2", "--out", out, "--cpu"])
    img = read_ppm(out)
    assert img.shape == (18, 32, 3)
    assert int(img[0, 16, 2]) > int(img[0, 16, 0])  # the top-center pixel is sky


def test_progressive_mega_over_culled_scene(final):
    """engine="mega" given a CulledScene renders the walk over it in the
    camera's visit order (cli.py: --engine mega --accel culled), tagged
    "mega+culled"."""
    _, camera, culled = final
    state = progressive.render_progressive(culled.scene, camera, seed=3, spp=2, batch=2,
                                           culled=culled, device="cpu")
    pack = mwk.build_walk_pack(culled, camera.center.numpy())
    want = mwk.render_wavefront_sum_mega_walk(pack, camera, 2, *progressive.batch_seeds(3, 0),
                                              device="cpu")
    assert state.engine == "mega+culled"
    np.testing.assert_array_equal(state.raw_sum, want.numpy())
