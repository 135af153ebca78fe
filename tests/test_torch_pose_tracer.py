"""The port's camera-pose gradients (plain versions, CPU) against the JAX
package, at tests/test_pose_tracer.py's CAM_KW (3 spheres, 24x24, depth 4,
defocus 0.8): make_tape_camera_pose_tracer's colors against the port's
camera tracer, its d cam_row against JAX's pose tracer (interpret mode,
once per module) and against autograd of the port's replay oracle chained
through camera_rays_host, common-random-number central differences on
cam_row entries, and the chain to lookfrom through the port's derive.

Bands: colors bit for bit; d cam_row rel < 5e-4 (test_pose_tracer.py:113)
against the replay oracle, and against JAX on the rays without a grazing
hit (test_torch_tapegrad._grazing_rays, 5 of 576 rays; measured 8.5e-5),
with all rays at the measured band below and the float64 walk printed as
referee (a grazing hit's rounding, ROADMAP Queue 3); finite differences
rtol 0.08, atol 0.05 (:151) and, for lookfrom, atol 0.3 (:182).
camera_rays_host is held to JAX's on most elements bit for bit and on the
rest within 4 ulp: XLA and torch round cos and sin (and XLA may contract a
product and a sum) differently on a few percent of the rays (measured 99
of 3,456 elements, at most 3 ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.grad import tapegrad as jtg
from distributed_raytracer_tpu.ops.camera import make_camera as jax_make_camera
from distributed_raytracer_tpu.ops.pallas.mega_render_kernel import (
    camera_rays_host as jax_camera_rays,
)
from distributed_raytracer_tpu.ops.pallas.mega_render_kernel import (
    camera_scalar_row as jax_camera_row,
)
from distributed_raytracer_tpu_torch import (
    SceneBuilder,
    make_tape_camera_pose_tracer,
    make_tape_camera_tracer,
)
from distributed_raytracer_tpu_torch.grad.tapegrad import replay_from_tape
from distributed_raytracer_tpu_torch.ops.camera import (
    camera_scalar_row,
    derive,
    make_camera,
)
from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk
from test_pose_tracer import CAM_KW, _scene
from test_torch_scene import to_port
from test_torch_tapegrad import _grazing_rays, _masked, _seeds

torch.set_num_threads(1)
KEY = 11  # test_pose_tracer.py's PRNGKey


# d cam_row against JAX's over all rays, the 5 with a grazing hit included
# (measured 6.8e-4; the float64 walk puts the port 1.4e-3 and JAX 9.4e-4
# from it there)
ALL_RAYS_REL = 2e-3


def _forward(ts, tc, bs, cs):
    cols, attrs, row = mrk.prepare(ts, tc, "cpu")
    return mk.mega_forward_camera(cols, attrs, row, None, bounce_seed=bs, cam_seed=cs, pix0=0,
                                  n_valid=tc.num_pixels, w=tc.image_width,
                                  max_depth=tc.max_depth)


@pytest.fixture(scope="module")
def case():
    """The scene, camera and seeds on both sides; JAX's pose-tracer
    gradients of sum(colors * gw) by cam_row, its forward run once: all
    rays, and the rays without a grazing hit (gw zero on the others)."""
    scene = _scene()
    cam = jax_make_camera(**CAM_KW)
    key = jax.random.PRNGKey(KEY)
    bs, cs = _seeds(key)
    gw = np.random.default_rng(2).standard_normal((cam.num_pixels, 3)).astype(np.float32)
    ts, tc = to_port(scene, cam)
    out = _forward(ts, tc, bs, cs)
    grazing = _grazing_rays(out.tape, out.lengths)
    with pltpu.force_tpu_interpret_mode():
        pose = jtg.make_tape_camera_pose_tracer(key, cam, pool=128, block_rays=128)
        _, vjp = jax.vjp(lambda cr: pose(scene, cr), jax_camera_row(cam))
        g = [np.asarray(vjp(jnp.asarray(w))[0])[0] for w in (gw, _masked(gw, grazing))]
        jax.block_until_ready(g)
    return dict(scene=scene, cam=cam, ts=ts, tc=tc, bs=bs, cs=cs, gw=gw, grazing=grazing,
                out=out, j_grad=g[0], j_calm=g[1])


def _port_cam_grad(c, gw):
    tc = c["tc"]
    pose = make_tape_camera_pose_tracer(tc, c["bs"], c["cs"], device="cpu")
    row = camera_scalar_row(tc).requires_grad_()
    colors = pose(c["ts"], row)
    (colors * torch.from_numpy(gw)).sum().backward()
    return colors.detach(), row.grad.numpy()


def test_camera_rays_host_matches_jax(case):
    c = case
    cam, tc = c["cam"], c["tc"]
    r = cam.num_pixels
    pix = np.arange(r, dtype=np.int32)
    row = camera_scalar_row(tc)
    assert np.array_equal(row.numpy(), np.asarray(jax_camera_row(cam))[0])
    jo, jd = jax_camera_rays(jax_camera_row(cam), jnp.asarray(pix), jnp.asarray(pix),
                             jnp.int32(c["cs"]), cam.image_width)
    po, pd = mrk.camera_rays_host(row, torch.from_numpy(pix), torch.from_numpy(pix), c["cs"],
                                  tc.image_width)
    got, want = torch.cat([po, pd], 1).numpy(), np.concatenate([jo, jd], 1)
    ulps = np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))
    print(f"camera_rays_host vs JAX: {int((got != want).sum())} of {got.size} elements "
          f"differ, by at most {ulps.max():.0f} ulp")
    assert (got != want).mean() < 0.05
    assert ulps.max() <= 4


def test_pose_forward_equals_camera_tracer(case):
    """The pose tracer's colors are the camera tracer's (iota pixels, equal
    seeds) bit for bit, and its cam_row gets a nonzero gradient."""
    c = case
    colors, g = _port_cam_grad(c, c["gw"])
    base = make_tape_camera_tracer(c["tc"], c["bs"], c["cs"], iota_pix=True, device="cpu")
    assert torch.equal(colors, base(c["ts"], torch.arange(c["tc"].num_pixels)))
    assert np.isfinite(g).all() and np.abs(g).max() > 1.0


def _rel(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def test_pose_cam_row_grads_match_jax(case):
    c = case
    assert 0 < c["grazing"].sum() < 0.02 * c["grazing"].size, c["grazing"].sum()
    _, calm = _port_cam_grad(c, _masked(c["gw"], c["grazing"]))
    _, g = _port_cam_grad(c, c["gw"])
    # the float64 walk on the port's tape, chained through camera_rays_host
    tc, out = c["tc"], c["out"]
    _, g_ray = wbk.mega_walk_backward_plain(out.tape, out.lengths, torch.from_numpy(c["gw"]),
                                            c["ts"].num_spheres, dtype=torch.float64,
                                            ray_grads=True)
    row = camera_scalar_row(tc).requires_grad_()
    pix = torch.arange(tc.num_pixels)
    o, d = mrk.camera_rays_host(row, pix, pix, c["cs"], tc.image_width)
    (ref,) = torch.autograd.grad([o, d], [row], [g_ray[:, 0:3].float(), g_ray[:, 3:6].float()])
    print(f"d cam_row vs JAX's pose tracer: rel {_rel(calm, c['j_calm']):.3g} without the "
          f"{int(c['grazing'].sum())} grazing rays, {_rel(g, c['j_grad']):.3g} with them; vs the "
          f"float64 walk, port {_rel(g, ref.numpy()):.3g}, JAX {_rel(c['j_grad'], ref.numpy()):.3g}")
    assert _rel(calm, c["j_calm"]) < 5e-4
    assert _rel(g, c["j_grad"]) < ALL_RAYS_REL
    assert np.abs(c["j_grad"]).max() > 1.0


def test_pose_cam_row_grads_match_replay_oracle(case):
    """d cam_row against autograd of the replay oracle re-reading its rays
    from camera_rays_host of a differentiable cam_row: the same recorded
    run, differentiated through the whole ray."""
    c = case
    tc, ts, out = c["tc"], c["ts"], c["out"]
    _, g = _port_cam_grad(c, c["gw"])
    r = tc.num_pixels
    row = camera_scalar_row(tc).requires_grad_()
    pix = torch.arange(r)
    o, d = mrk.camera_rays_host(row, pix, pix, c["cs"], tc.image_width)
    colors = replay_from_tape(ts, out.tape, out.lengths, r, o, d)
    (colors * torch.from_numpy(c["gw"])).sum().backward()
    print(f"d cam_row vs the replay oracle: rel {_rel(g, row.grad.numpy()):.3g}")
    assert _rel(g, row.grad.numpy()) < 5e-4


def test_pose_tracer_fd_edge_free():
    """Central differences with common random numbers (the draws are keyed
    by pixel and seed, not by the camera) on an edge-free view (one giant
    sphere fills the frame, so the pathwise gradient is the total
    derivative): test_pose_tracer.py:117-151 in the port."""
    scene = SceneBuilder().add_lambertian((0, 0, -52.0), 50.0, (0.6, 0.4, 0.3)).build()
    cam = make_camera(aspect_ratio=1.0, image_width=16, samples_per_pixel=1, max_depth=3,
                      vfov=40.0, lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -1.0),
                      vup=(0.0, 1.0, 0.0), defocus_angle=0.0, focus_dist=3.0)
    bs, cs = _seeds(jax.random.PRNGKey(4))
    gw = torch.from_numpy(np.random.default_rng(5).standard_normal((cam.num_pixels, 3))
                          .astype(np.float32))
    pose = make_tape_camera_pose_tracer(cam, bs, cs, device="cpu")
    row0 = camera_scalar_row(cam)

    def loss(cr):
        return (pose(scene, cr) * gw).sum()

    row = row0.clone().requires_grad_()
    loss(row).backward()
    g = row.grad.numpy()
    for k in (0, 2, 3, 6):  # center.x/.z, pixel00.x, pixel_delta_u.x
        eps = 1e-3
        e = torch.zeros(24)
        e[k] = eps
        with torch.no_grad():
            fd = (float(loss(row0 + e)) - float(loss(row0 - e))) / (2 * eps)
        assert np.isfinite(g[k])
        np.testing.assert_allclose(g[k], fd, rtol=0.08, atol=0.05, err_msg=f"entry {k}")


def test_pose_grads_chain_to_lookfrom(case):
    """d loss / d lookfrom through the port's derive (tensor operations, so
    autograd carries the cam_row cotangents to the pose), finite, nonzero
    and consistent with central differences (test_pose_tracer.py:154-182)."""
    c = case
    tc = c["tc"]
    gw = torch.from_numpy(np.random.default_rng(3).standard_normal((tc.num_pixels, 3))
                          .astype(np.float32))
    pose = make_tape_camera_pose_tracer(tc, c["bs"], c["cs"], device="cpu")

    def loss_of_lookfrom(lf):
        d = derive(tc.image_width, tc.image_height, CAM_KW["vfov"], lf, CAM_KW["lookat"],
                   CAM_KW["vup"], CAM_KW["defocus_angle"], CAM_KW["focus_dist"])
        return (pose(c["ts"], camera_scalar_row(tc.replace(**d))) * gw).sum()

    lf0 = torch.tensor(CAM_KW["lookfrom"], dtype=torch.float32)
    lf = lf0.clone().requires_grad_()
    loss_of_lookfrom(lf).backward()
    g = lf.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    eps = 2e-3
    e = torch.tensor([0.0, 0.0, eps])
    with torch.no_grad():
        fd = (float(loss_of_lookfrom(lf0 + e)) - float(loss_of_lookfrom(lf0 - e))) / (2 * eps)
    np.testing.assert_allclose(g[2], fd, rtol=0.08, atol=0.3)


def test_pose_tracer_checks_cam_row(case):
    pose = make_tape_camera_pose_tracer(case["tc"], 1, 2, device="cpu")
    with pytest.raises(ValueError, match="cam_row"):
        pose(case["ts"], torch.zeros(1, 24))
