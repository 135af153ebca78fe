"""The port's distributed layer (parallel/) on the CPU, one process: the
ray-sharded factories run every rank's `local` shard in turn, at 32x16
and a world of 3, which does not divide the image (the last shard short),
and a 7-pixel image over 5 ranks (the last shard empty).

Held against JAX's single-device references, never a JAX shard_map:
ShardedRenderer against sharded._render_ids of the whole image, and the
sharded grad fn against jax.value_and_grad of that loss, at the bands of
tests/test_parallel.py (atol 1e-4 on pixels, 5e-4 of each field's max).
The mega, walk and camera paths (their plain versions here) are the
port's single-device paths bit for bit; the tape dp tracer and the fused
dp render equal per-shard single-device runs with fold_in(key, rank).
The scene-sharded paths need collectives inside every bounce and run in
tests/test_torch_multihost.py's gloo workers.  shard_scene_spatial and the
AABB helpers against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models import aabb as jaabb
from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from distributed_raytracer_tpu.ops.camera import make_camera as jax_make_camera
from distributed_raytracer_tpu.parallel import spatial as jspatial
from distributed_raytracer_tpu.parallel.sharded import _render_ids as jax_render_ids
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.grad.diff_render import image_loss
from distributed_raytracer_tpu_torch.grad.tapegrad import (
    make_tape_camera_tracer,
    make_tape_camera_walk_tracer,
    make_tape_tracer,
)
from distributed_raytracer_tpu_torch.models import aabb
from distributed_raytracer_tpu_torch.models import presets as tp
from distributed_raytracer_tpu_torch.ops.camera import Camera, generate_rays, make_camera
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import build_culled_scene
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import (
    render_wavefront_sum_mega,
)
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_kernel import (
    render_wavefront_sum_mega_walk,
    walk_pack_for,
)
from distributed_raytracer_tpu_torch.parallel import (
    Mesh,
    ShardedRenderer,
    make_fused_dp_render,
    make_mega_dp_render,
    make_mega_walk_dp_render,
    make_mesh,
    make_sharded_grad_fn,
    make_tape_camera_dp_tracer,
    make_tape_camera_walk_dp_tracer,
    make_tape_dp_tracer,
    shard_scene_spatial,
)
from distributed_raytracer_tpu_torch.parallel import mesh as pmesh
from distributed_raytracer_tpu_torch.parallel.sharded import shard_span, shard_size
from distributed_raytracer_tpu_torch.render.wavefront import render_wavefront_sum_fused
from test_torch_scene import camera_arrays, to_port

WORLD = 3
DIFF = ("centers", "radii", "albedo", "fuzz", "ior")
GRAD_BAND = 5e-4      # tests/test_parallel.py:226, of each field's max
ATOMICS_BAND = 1e-5   # two sums of the same terms in another order
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_scene_and_cam(width=32):
    """tests/test_parallel.py's scene and camera (32x16 at width 32)."""
    scene = (JaxSceneBuilder()
             .add_lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))
             .add_lambertian((0, 0, -1.2), 0.5, (0.1, 0.2, 0.5))
             .add_metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.2)
             .add_dielectric((-1, 0, -1), 0.5, 1.5)
             .add_metal((0.3, -0.2, -0.8), 0.15, (0.9, 0.3, 0.3), 0.0)
             .build())
    cam = jax_make_camera(aspect_ratio=2.0, image_width=width, samples_per_pixel=4,
                          max_depth=6)
    return scene, cam


@pytest.fixture(scope="module")
def setup():
    js, jc = jax_scene_and_cam()
    return js, jc, to_port(js), Camera.from_numpy(camera_arrays(jc), CPU)


def band(got, want, tol, name=""):
    scale = np.abs(want).max() + 1e-8
    err = np.abs(got - want).max() / scale
    assert err <= tol, (name, err)
    return err


# ---- mesh ----

def test_mesh_layout_and_collectives():
    m = Mesh(n_rays=4, n_scene=2, rank=5)
    assert (m.rays_index, m.scene_index) == (2, 1)
    assert m.shape == {"rays": 4, "scene": 2} and m.size == 8
    one = make_mesh()  # no process group: a 1 x 1 mesh, collectives the identity
    assert one.shape == {"rays": 1, "scene": 1}
    x = torch.arange(6.0).reshape(2, 3)
    assert pmesh.axis_sum(x, one, "rays") is x
    assert torch.equal(pmesh.axis_gather(x, one, "scene"), x[None])
    assert pmesh.gather_blocks(x, one) is x and pmesh.sum_blocks(x, one) is x
    assert pmesh.replicate([x], one)[0] is x
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_rays=2)
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.axis_sum(x, Mesh(n_rays=2), "rays")
    assert pmesh.pad_to_multiple(10, 4) == 12
    assert shard_size(512, 3) == 171
    assert [shard_span(7, 2, r) for r in range(5)] == [(0, 2), (2, 2), (4, 2), (6, 1), (8, 0)]


# ---- ShardedRenderer and the sharded grad fn, against JAX ----

@pytest.fixture(scope="module")
def jax_reference(setup):
    js, jc, _, cam = setup
    key = jax.random.PRNGKey(3)
    s = jnp.arange(2, dtype=jnp.int32)
    n = cam.num_pixels
    ids = jnp.arange(n, dtype=jnp.int32)
    img = np.asarray(jax.jit(lambda sc: jax_render_ids(sc, jc, key, s, ids, False))(js))
    target = np.random.default_rng(1).random((n, 3)).astype(np.float32)

    def loss(params):
        total = jax_render_ids(js.with_diff_params(params), jc, key, s, ids, True)
        return jnp.sum((total / 2 - target) ** 2) / (3.0 * n)

    lv, g = jax.jit(jax.value_and_grad(loss))(js.diff_params())
    return img, target, float(lv), {k: np.asarray(v) for k, v in g.items()}


def test_sharded_renderer_matches_jax_and_every_world(setup, jax_reference):
    _, _, scene, cam = setup
    key = prng.PRNGKey(3)
    parts = {}
    for world in (1, WORLD):
        r = ShardedRenderer(Mesh(n_rays=world), cam, device=CPU)
        parts[world] = torch.cat([r.local(scene, key, [0, 1], k) for k in range(world)])
    n = cam.num_pixels
    # the rows draw from the whole image's draws: bit for bit at any world size
    assert torch.equal(parts[1][:n], parts[WORLD][:n])
    np.testing.assert_allclose(parts[WORLD][:n].numpy(), jax_reference[0], rtol=0, atol=1e-4)
    one = ShardedRenderer(make_mesh(), cam, device=CPU)
    assert torch.equal(one.render_sample_sum(scene, key, [0, 1]), parts[1][:n])
    img = one.render_image(scene, seed=3, spp=2, batch=1)
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()


def test_sharded_grad_fn_matches_jax(setup, jax_reference):
    _, _, scene, cam = setup
    _, target, want_loss, want = jax_reference
    grad_fn = make_sharded_grad_fn(Mesh(n_rays=WORLD), cam, device=CPU)
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    loss = sum(grad_fn.local(leaves, scene, prng.PRNGKey(3), [0, 1], target, k)
               for k in range(WORLD))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for k in DIFF:
        band(leaves[k].grad.numpy(), want[k], GRAD_BAND, k)
    # a 1 x 1 mesh through the collective entry point: the same loss
    l1, g1 = make_sharded_grad_fn(make_mesh(), cam, device=CPU)(
        scene, prng.PRNGKey(3), [0, 1], target)
    np.testing.assert_allclose(float(l1), float(loss.detach()), rtol=1e-6)
    for k in DIFF:
        band(g1[k].numpy(), want[k], GRAD_BAND, k)


# ---- the kernel paths (plain versions on the CPU) ----

def _final(width):
    return tp.rtiow_final_scene(seed=0, pad_to=512), tp.final_scene_camera(width).replace(
        max_depth=5)


def test_mega_dp_render_bit_for_bit():
    scene, cam = _final(32)
    bs, cs = 11, 22
    whole = render_wavefront_sum_mega(scene, cam, 3, bs, cs, device=CPU)
    dp = make_mega_dp_render(Mesh(n_rays=WORLD), cam, device=CPU)
    parts = [dp.local(scene, bs, cs, [0, 1, 2], k) for k in range(WORLD)]
    got = torch.cat(parts)
    n = cam.num_pixels
    assert torch.equal(got[:n], whole)
    # batches of absolute samples through acc: the same bits
    split = [dp.local(scene, bs, cs, [2], k, acc=dp.local(scene, bs, cs, [0, 1], k))
             for k in range(WORLD)]
    assert torch.equal(torch.cat(split), got)
    # a 7-pixel image over 5 ranks: the last shard holds no pixel
    cam7 = make_camera(aspect_ratio=7.0, image_width=7, max_depth=4)
    dp7 = make_mega_dp_render(Mesh(n_rays=5), cam7, device=CPU)
    got7 = torch.cat([dp7.local(scene, bs, cs, [0], k) for k in range(5)])
    assert torch.equal(got7[:7], render_wavefront_sum_mega(scene, cam7, 1, bs, cs, device=CPU))
    assert not got7[7:].any()


def test_mega_walk_dp_render_bit_for_bit():
    field = tp.random_sphere_field(40, seed=5, extent=6.0)
    cam = make_camera(aspect_ratio=2.0, image_width=20, max_depth=4, lookfrom=(0.0, 3.0, 12.0),
                      lookat=(0.0, 0.5, 0.0))
    pack = walk_pack_for(field, cam, chunk=16)
    whole = render_wavefront_sum_mega_walk(pack, cam, 2, 5, 6, device=CPU)
    dp = make_mega_walk_dp_render(Mesh(n_rays=WORLD), pack, cam, device=CPU)
    got = torch.cat([dp.local(5, 6, [0, 1], k) for k in range(WORLD)])
    assert torch.equal(got[:cam.num_pixels], whole)


def test_camera_dp_tracer_colors_bit_for_bit_grads_in_band():
    scene, cam = _final(32)
    n = cam.num_pixels
    target = torch.from_numpy(np.random.default_rng(2).random((n, 3)).astype(np.float32))
    single = make_tape_camera_tracer(cam, 7, 8, iota_pix=True, device=CPU)
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    want = single(scene.with_diff_params(leaves), torch.zeros(n))
    image_loss(want, target).backward()
    g_want = {k: v.grad.numpy() for k, v in leaves.items()}

    dp = make_tape_camera_dp_tracer(Mesh(n_rays=WORLD), cam, 7, 8, device=CPU)
    s_loc = shard_size(n, WORLD)
    tgt = torch.cat([target, torch.zeros(WORLD * s_loc - n, 3)])
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    s = scene.with_diff_params(leaves)
    parts = [dp.local(s, k) for k in range(WORLD)]
    got = torch.cat(parts)
    assert torch.equal(got[:n], want.detach()) and not got[n:].any()
    loss = sum(((p - tgt[k * s_loc:(k + 1) * s_loc]) ** 2).sum() for k, p in enumerate(parts))
    (loss / (3.0 * n)).backward()
    for k in DIFF:
        band(leaves[k].grad.numpy(), g_want[k], ATOMICS_BAND, k)


def test_camera_dp_tracer_empty_shard():
    """A shard with no real pixel gives zero rows and zero gradients; the
    others equal the single-device tracer."""
    scene, _ = _final(32)
    cam7 = make_camera(aspect_ratio=7.0, image_width=7, max_depth=3, lookfrom=(13.0, 2.0, 3.0),
                       lookat=(0.0, 0.0, 0.0), vfov=20.0)
    dp = make_tape_camera_dp_tracer(Mesh(n_rays=5), cam7, 3, 4, device=CPU)
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    parts = [dp.local(scene.with_diff_params(leaves), k) for k in range(5)]
    assert not parts[4].any() and not parts[3][1:].any()
    (parts[4].sum() * 1.0).backward()
    assert all(not leaves[k].grad.any() for k in DIFF)
    want = make_tape_camera_tracer(cam7, 3, 4, iota_pix=True, device=CPU)(scene, torch.zeros(7))
    assert torch.equal(torch.cat(parts)[:7].detach(), want)


def test_walk_dp_tracer_colors_bit_for_bit_grads_in_band():
    field = tp.random_sphere_field(40, seed=5, extent=6.0)
    cam = make_camera(aspect_ratio=2.0, image_width=20, max_depth=4, lookfrom=(0.0, 3.0, 12.0),
                      lookat=(0.0, 0.5, 0.0))
    n = cam.num_pixels
    single = make_tape_camera_walk_tracer(cam, 3, 4, field, chunk=16, device=CPU)
    leaves = {k: getattr(field, k).clone().requires_grad_() for k in DIFF}
    want = single(field.with_diff_params(leaves), torch.arange(n))
    (want ** 2).sum().backward()
    g_want = {k: v.grad.numpy() for k, v in leaves.items()}
    dp = make_tape_camera_walk_dp_tracer(Mesh(n_rays=WORLD), cam, 3, 4, field, chunk=16,
                                         device=CPU)
    leaves = {k: getattr(field, k).clone().requires_grad_() for k in DIFF}
    parts = [dp.local(field.with_diff_params(leaves), k) for k in range(WORLD)]
    got = torch.cat(parts)
    assert torch.equal(got[:n], want.detach())
    sum((p ** 2).sum() for p in parts).backward()
    for k in DIFF:
        band(leaves[k].grad.numpy(), g_want[k], ATOMICS_BAND, k)


@pytest.mark.parametrize("mode", ["host", "mega"])
def test_tape_dp_tracer_equals_per_shard_runs(setup, mode):
    _, _, scene, cam = setup
    r = 48 * WORLD
    ids = torch.arange(r)
    o, d = generate_rays(cam, ids % cam.image_width, ids // cam.image_width,
                         key=prng.PRNGKey(5))
    key = prng.PRNGKey(9)
    opts = dict(pool=32) if mode == "host" else dict(use_mega=True)
    dp = make_tape_dp_tracer(Mesh(n_rays=WORLD), key, 6, device=CPU, **opts)
    local = make_tape_tracer(key, 6, device=CPU, **opts)
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    dd = d.clone().requires_grad_()
    parts = [dp.local(scene.with_diff_params(leaves), o, dd, k) for k in range(WORLD)]
    sum((p ** 2).sum() for p in parts).backward()
    s = r // WORLD
    ref_leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    dr = d.clone().requires_grad_()
    refs = [local(scene.with_diff_params(ref_leaves), o[k * s:(k + 1) * s],
                  dr[k * s:(k + 1) * s], prng.fold_in(key, k)) for k in range(WORLD)]
    assert torch.equal(torch.cat(parts).detach(), torch.cat(refs).detach())
    sum((p ** 2).sum() for p in refs).backward()
    for k in DIFF:
        band(leaves[k].grad.numpy(), ref_leaves[k].grad.numpy(), 1e-6, k)
    assert torch.equal(dd.grad, dr.grad)


@pytest.mark.parametrize("culled", [False, True])
def test_fused_dp_render_equals_per_shard_runs(culled):
    scene, cam = _final(16)
    key = prng.PRNGKey(4)
    cs = build_culled_scene(scene, chunk=128) if culled else None
    sc = cs.scene if culled else scene
    dp = make_fused_dp_render(Mesh(n_rays=WORLD), cam, pool_size=64, culled=cs, device=CPU)
    n = cam.num_pixels
    s_loc = shard_size(n, WORLD)
    ids = torch.cat([torch.arange(n), torch.zeros(WORLD * s_loc - n, dtype=torch.int64)])
    for k in range(WORLD):
        bs, cseed = prng.seed_pair(prng.fold_in(key, k))
        want = render_wavefront_sum_fused(sc, cam, 2, bs, cseed, pool_size=64,
                                          pixel_ids=ids[k * s_loc:(k + 1) * s_loc], culled=cs,
                                          device=CPU)
        assert torch.equal(dp.local(sc, key, 2, k), want), k


# ---- spatial sharding and the AABB helpers, against JAX ----

def test_aabb_helpers_match_jax():
    cells_t, cells_j = aabb.grid_cells(n_x=4, n_z=3), jaabb.grid_cells(n_x=4, n_z=3)
    np.testing.assert_array_equal(cells_t.lo.numpy(), np.asarray(cells_j.lo))
    np.testing.assert_array_equal(cells_t.hi.numpy(), np.asarray(cells_j.hi))
    rng = np.random.default_rng(0)
    c = rng.uniform(-15, 15, (50, 3)).astype(np.float32)
    r = rng.uniform(0.1, 3, 50).astype(np.float32)
    got = aabb.intersect_sphere(aabb.AABB(cells_t.lo[:, None], cells_t.hi[:, None]),
                                torch.from_numpy(c)[None], torch.from_numpy(r)[None])
    want = jaabb.intersect_sphere(jaabb.AABB(cells_j.lo[:, None], cells_j.hi[:, None]),
                                  jnp.asarray(c)[None], jnp.asarray(r)[None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 2, 1])
    o = rng.uniform(-4, 4, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    got = aabb.hit_interval(aabb.AABB(torch.from_numpy(lo), torch.from_numpy(hi)),
                            torch.from_numpy(o), torch.from_numpy(d))
    want = jaabb.hit_interval(jaabb.AABB(jnp.asarray(lo), jnp.asarray(hi)), jnp.asarray(o),
                              jnp.asarray(d))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_scene_spatial_matches_jax_and_keeps_the_closest_hit(n_shards):
    js = jp.rtiow_final_scene(seed=0)
    got = shard_scene_spatial(to_port(js), n_shards)
    want = jspatial.shard_scene_spatial(js, n_shards)
    for k in ("centers", "radii", "albedo", "mat_type", "fuzz", "ior"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.num_spheres % n_shards == 0
    # every real sphere kept, the closest hit unchanged (test_aabb_spatial.py:68-107)
    scene = to_port(js)
    rng = np.random.default_rng(1)
    o = torch.from_numpy(np.c_[rng.uniform(-10, 10, 256), rng.uniform(0.5, 4, 256),
                               rng.uniform(-10, 10, 256)].astype(np.float32))
    d = torch.from_numpy(np.c_[rng.normal(size=256), -np.abs(rng.normal(size=256)) - 0.2,
                               rng.normal(size=256)].astype(np.float32))
    a, b = closest_hit(o, d, scene), closest_hit(o, d, got)
    assert torch.equal(a.hit, b.hit)
    h = a.hit
    np.testing.assert_allclose(b.t[h].numpy(), a.t[h].numpy(), rtol=1e-5)
    for k in ("centers", "radii", "albedo", "mat_type"):
        assert torch.equal(getattr(got, k)[b.idx.long()][h], getattr(scene, k)[a.idx.long()][h])


@pytest.mark.parametrize("factory", ["sharded_renderer", "grad_fn", "tape_dp", "camera_dp",
                                     "mega_dp", "fused_dp", "scene_sharded", "tape_2d"])
def test_factories_default_to_the_card(factory):
    """device=None means the CUDA card: without one the factories refuse
    to run rather than carry on on the CPU."""
    from distributed_raytracer_tpu_torch.parallel import (
        make_scene_sharded_render,
        make_tape_2d_tracer,
    )

    cam = make_camera(image_width=4, max_depth=1)
    mesh = Mesh(n_rays=2)
    make = {
        "sharded_renderer": lambda: ShardedRenderer(mesh, cam),
        "grad_fn": lambda: make_sharded_grad_fn(mesh, cam),
        "tape_dp": lambda: make_tape_dp_tracer(mesh, prng.PRNGKey(1), 2),
        "camera_dp": lambda: make_tape_camera_dp_tracer(mesh, cam, 1, 2),
        "mega_dp": lambda: make_mega_dp_render(mesh, cam),
        "fused_dp": lambda: make_fused_dp_render(mesh, cam),
        "scene_sharded": lambda: make_scene_sharded_render(Mesh(1, 2), cam),
        "tape_2d": lambda: make_tape_2d_tracer(Mesh(1, 2), prng.PRNGKey(1), 2),
    }[factory]
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
