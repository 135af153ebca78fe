"""The port's walk engine (plain versions, CPU) against the JAX package:
the walk-pack builders against JAX's host code (no Pallas), the plain
walk render against JAX's mega_walk_colors in interpret mode and against
the port's dense plain trace, and render_progressive's routing past 512
spheres.

Bands: the pack arrays equal; walk colors against JAX's host oracle
(tests/test_mega_render.py::_oracle_sample) at the North-star depth-8 band
(max < 5e-4, mean < 5e-6; measured 8.7e-6 and 5.7e-8 at depth 6).  On
this scene JAX's interpret walk kernel differs from its own host oracle on
4 to 7 of 312 pixels, by host (up to 0.28; the R = 1000 ground sphere's
c_q cancels, so a one-ulp difference in how XLA:CPU rounds flips a ray's
self-intersection: ROADMAP Queue 3), so the port is held to the
interpret kernel at the depth-8 band on every pixel where that kernel
stands within the band of its own oracle, and must part from it on no
other pixel.  The plain walk equals the dense plain trace bit for bit
(the walk's winner is the dense argmin over its slots), and so does every
routed render."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu import native as jax_native
from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.ops.pallas import mega_walk_kernel as jmwk
from distributed_raytracer_tpu_torch import native as port_native
from distributed_raytracer_tpu_torch.models import presets as tp
from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row
from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
from distributed_raytracer_tpu_torch.ops.kernels.bounce import scene_sweep_arrays
from distributed_raytracer_tpu_torch.render import progressive
from test_mega_render import _oracle_sample
from test_torch_scene import to_port

torch.set_num_threads(1)
S, BS, CS = 2, 31337, 271828


def _field_camera(m, width=24, depth=6):
    """test_mega_walk.py:119-124's camera, in package m (jp or tp)."""
    return m.make_camera(aspect_ratio=16.0 / 9.0, image_width=width, samples_per_pixel=1,
                         max_depth=depth, vfov=40.0, lookfrom=(0.0, 6.0, 25.0),
                         lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0), defocus_angle=0.0,
                         focus_dist=10.0)


def _bench_camera(m):
    """bench.py:317-322's walk camera, 1024x576 depth 8."""
    return m.make_camera(aspect_ratio=16.0 / 9.0, image_width=1024, samples_per_pixel=8,
                         max_depth=8, vfov=55.0, lookfrom=(0.0, 20.0, 60.0),
                         lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0), defocus_angle=0.0,
                         focus_dist=10.0)


def test_same_cluster_builder():
    """The pack comparisons need both packages on the same cluster builder:
    the C++ one bounds in double, the NumPy fallbacks in float32, so the
    two can order and bound differently in the last bits."""
    assert port_native.available() == jax_native.available(), (
        f"port C++ builder {port_native.available()}, JAX's {jax_native.available()}")


@pytest.mark.parametrize("n,seed,extent,chunk", [(600, 7, 12.0, 128), (8192, 5, 30.0, 256)],
                         ids=["field600-chunk128", "field8192-chunk256"])
def test_numpy_cluster_builder(n, seed, extent, chunk, monkeypatch):
    """The NumPy fallback of build_clusters, forced on both sides: the
    port's equals JAX's bit for bit, its order is a permutation, and each
    bound covers every member sphere (|center - bound center| + radius, in
    float64) to within 2 ulps of the bound radius.  Both builders round
    the radius to float32, the C++ one from double and the fallback from
    float32 sums, so neither covers exactly: measured up to 0.51 ulp
    (C++) and 1.17 ulp (fallback) short on the 8,192 field.  At the 600
    field the walk over the fallback's pack still equals the dense plain
    trace bit for bit."""
    scene = tp.random_sphere_field(n, seed=seed, extent=extent)
    small = scene.radii.numpy() < 50.0  # the clustered spheres (culled_kernel.py)
    centers, radii = scene.centers.numpy()[small], scene.radii.numpy()[small]
    monkeypatch.setattr(port_native, "_load", lambda: None)
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    order, bounds = port_native.build_clusters(centers, radii, chunk)
    want_order, want_bounds = jax_native.build_clusters(centers, radii, chunk)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(bounds, want_bounds)
    assert np.array_equal(np.sort(order), np.arange(len(radii)))
    for c, (b, r) in enumerate(zip(bounds[:, :3].astype(np.float64), bounds[:, 3])):
        m = order[c * chunk:(c + 1) * chunk]
        need = np.linalg.norm(centers[m].astype(np.float64) - b, axis=-1) + radii[m]
        assert need.max() - r <= 2 * np.spacing(r), (c, need.max() - r)
    if n > 512:
        return
    camera = _field_camera(tp, width=16, depth=4)
    pack = mwk.walk_pack_for(scene, camera, chunk=chunk)
    cam_row, px = camera_scalar_row(camera), camera.num_pixels
    kw = dict(bounce_seed=BS, cam_seed=CS, rid_base=0, pix0=0, n_valid=px, n_cap=px,
              w=camera.image_width, max_depth=camera.max_depth)
    walk, _ = mwk.mega_walk_sample(pack.scene_pack, pack.attrs, pack.bounds, pack.chunk_len,
                                   cam_row, **kw)
    dense, _ = mrk.mega_render_plain(*scene_sweep_arrays(scene), cam_row, **kw)
    assert torch.equal(walk, dense)


@pytest.mark.parametrize("n,seed,extent,chunk,bench", [
    (600, 7, 12.0, 128, False), (600, 7, 12.0, 256, False), (8192, 5, 30.0, 256, True)],
    ids=["field600-chunk128", "field600-chunk256", "field8192-chunk256"])
def test_pack_matches_jax(n, seed, extent, chunk, bench):
    js = jp.random_sphere_field(n, seed=seed, extent=extent)
    jc = _bench_camera(jp) if bench else _field_camera(jp)
    want = jmwk.walk_pack_for(js, jc, chunk=chunk)
    ts, tc = to_port(js, jc)
    got = mwk.walk_pack_for(ts, tc, chunk=chunk)
    assert got.n_chunks == want.n_chunks and got.chunk == chunk
    np.testing.assert_array_equal(got.slot_to_orig, np.asarray(want.slot_to_orig))
    np.testing.assert_array_equal(got.bounds.numpy(), np.asarray(want.bounds)[:, :4])
    np.testing.assert_array_equal(got.scene_pack.numpy(), np.asarray(want.scene_pack)[:, :4])
    # the spheres lead each chunk, so a chunk sweeps chunk_len slots
    sto = got.slot_to_orig.reshape(got.n_chunks, chunk)
    lens = got.chunk_len.numpy()
    assert ((np.arange(chunk)[None, :] < lens[:, None]) == (sto >= 0)).all()
    # the slot-ordered attributes are the original spheres' (idx = slot)
    live = got.slot_to_orig >= 0
    _, attrs = scene_sweep_arrays(ts)
    np.testing.assert_array_equal(got.attrs.numpy()[:10, live],
                                  attrs.numpy()[:10, got.slot_to_orig[live]])
    np.testing.assert_array_equal(got.attrs.numpy()[10], np.arange(got.n_slots))
    if bench:
        assert (got.n_chunks, got.n_slots, ts.num_spheres) == (33, 8448, 8193)


@pytest.fixture(scope="module")
def field601():
    """test_mega_walk.py:98-133's scene and camera (601 spheres, 24 wide,
    depth 6, chunk 128), JAX's walk colors in interpret mode and its host
    oracle's, and the port's walk colors, scene, camera and pack."""
    js = jp.random_sphere_field(600, seed=7, extent=12.0)
    jc = _field_camera(jp)
    jpack = jmwk.walk_pack_for(js, jc, chunk=128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmwk.mega_walk_colors(jpack, jc, jnp.int32(S), jnp.int32(BS),
                                                jnp.int32(CS), pool=128, block_rays=128))
    oracle = np.asarray(_oracle_sample(js, jc, jnp.int32(S), jnp.int32(BS), jnp.int32(CS)))
    ts, tc = to_port(js, jc)
    pack = mwk.walk_pack_for(ts, tc, chunk=128)
    got = mwk.mega_walk_colors(pack, tc, S, BS, CS, device="cpu").numpy()
    return (want, oracle, got), ts, tc, pack


def test_walk_matches_jax_host_oracle(field601):
    (_, oracle, got), ts, tc, pack = field601
    assert ts.num_spheres == 601 and pack.n_chunks >= 5
    d = np.abs(got - oracle)
    assert d.max() < 5e-4, d.max()
    assert d.mean() < 5e-6, d.mean()


def test_walk_matches_jax_interpret(field601):
    (want, oracle, got), _, _, _ = field601
    d = np.abs(got - want)
    over = d.max(axis=1) > 5e-4
    # where JAX's kernel stands within the depth-8 band of its own oracle,
    # the port stands within it of JAX's kernel
    jax_ok = np.abs(want - oracle).max(axis=1) <= 5e-4
    assert jax_ok.sum() >= 0.9 * jax_ok.size, jax_ok.size - jax_ok.sum()
    assert d[jax_ok].max() < 5e-4, d[jax_ok].max()
    assert d[jax_ok].mean() < 5e-6, d[jax_ok].mean()
    # the pixels where the port parts from JAX's kernel are those where
    # JAX's kernel parts from its own oracle
    assert not (over & jax_ok).any(), np.nonzero(over & jax_ok)


def test_walk_equals_dense_plain_trace(field601):
    """At equal content the walk's colors and bounce count are the dense
    plain trace's, bit for bit; its counters are those of a walk that
    culls (fewer slot tests than the dense sweep)."""
    _, ts, tc, pack = field601
    n = tc.num_pixels
    kw = dict(bounce_seed=BS, cam_seed=CS, rid_base=S * n, pix0=0, n_valid=n, n_cap=n,
              w=tc.image_width, max_depth=tc.max_depth)
    cols, attrs = scene_sweep_arrays(ts)
    dense, bounces = mrk.mega_render_plain(cols, attrs, camera_scalar_row(tc), **kw)
    walk, stats = mwk.mega_walk_sample(pack.scene_pack, pack.attrs, pack.bounds,
                                       pack.chunk_len, camera_scalar_row(tc), **kw)
    assert torch.equal(walk, dense)
    b, admitted, tests, near = stats.tolist()
    assert b == int(bounces)
    assert b <= admitted <= b * pack.n_chunks
    assert near <= tests < b * ts.num_spheres


def test_cuda_wrappers_reject_cpu_tensors(field601):
    _, ts, tc, pack = field601
    args = (pack.scene_pack, pack.attrs, pack.bounds, pack.chunk_len, camera_scalar_row(tc))
    before = mwk.mega_walk_sample_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        mwk.mega_walk_sample_cuda(*args, bounce_seed=0, cam_seed=0, rid_base=0, pix0=0,
                                  n_valid=4, n_cap=4, w=tc.image_width, max_depth=2)
    with pytest.raises(ValueError, match="CUDA"):
        mwk.mega_walk_forward_camera_cuda(*args, bounce_seed=0, cam_seed=0, pix0=0, n_valid=4,
                                          w=tc.image_width, max_depth=2)
    assert mwk.mega_walk_sample_cuda.launches == before


@pytest.fixture(scope="module")
def routed():
    scene = tp.random_sphere_field(600, seed=7, extent=12.0)
    camera = _field_camera(tp, width=16, depth=4)
    return scene, camera


def test_progressive_routes_past_512_to_walk(routed, monkeypatch):
    scene, camera = routed

    def dense(*a, **k):
        raise AssertionError("the dense engine ran past 512 spheres")

    monkeypatch.setattr(progressive, "render_wavefront_sum_mega", dense)
    state = progressive.render_progressive(scene, camera, seed=5, spp=2, batch=2,
                                           device="cpu")
    pack = mwk.walk_pack_for(scene, camera, chunk=256)
    want = mwk.render_wavefront_sum_mega_walk(pack, camera, 2, *progressive.batch_seeds(5, 0),
                                              device="cpu")
    np.testing.assert_array_equal(state.raw_sum, want.numpy())


def test_progressive_walk_resume_is_bit_identical(routed, tmp_path):
    scene, camera = routed
    whole = progressive.render_progressive(scene, camera, seed=7, spp=4, batch=2, device="cpu")
    ckpt = str(tmp_path / "ck.npz")
    progressive.render_progressive(scene, camera, seed=7, spp=2, batch=2, device="cpu",
                                   checkpoint_path=ckpt)
    resumed = progressive.render_progressive(scene, camera, seed=7, spp=4, batch=2,
                                             device="cpu", checkpoint_path=ckpt)
    assert resumed.samples_done == 4
    np.testing.assert_array_equal(resumed.raw_sum, whole.raw_sum)


def test_progressive_keeps_dense_up_to_512(monkeypatch):
    scene, _ = tp.config2()
    camera = _field_camera(tp, width=16, depth=4)

    def walk(*a, **k):
        raise AssertionError("the walk ran on a scene of at most 512 spheres")

    monkeypatch.setattr(progressive, "walk_pack_for", walk)
    monkeypatch.setattr(progressive, "render_wavefront_sum_mega_walk", walk)
    state = progressive.render_progressive(scene, camera, seed=5, spp=1, batch=1, device="cpu")
    want = mrk.render_wavefront_sum_mega(scene, camera, 1, *progressive.batch_seeds(5, 0),
                                         device="cpu")
    np.testing.assert_array_equal(state.raw_sum, want.numpy())
