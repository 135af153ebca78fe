"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA card with nvcc; elsewhere they skip.  Run them on
the card with `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(--noconftest: tests/conftest.py imports jax, which a CUDA machine need not have)."""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch import (
    Scene,
    image_loss,
    make_tape_camera_pose_tracer,
    make_tape_camera_tracer,
    make_tape_camera_walk_tracer,
    make_tape_tracer,
)
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.models import presets
from distributed_raytracer_tpu_torch.ops.camera import Camera, camera_scalar_row
from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
from distributed_raytracer_tpu_torch.ops.kernels import mega_bwd_kernel as mbk
from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import build_culled_scene
from distributed_raytracer_tpu_torch.render import wavefront

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("which,depth", [("config2", 8), ("final", 1), ("final", 8)])
def test_kernel_matches_plain_on_card(card, which, depth):
    scene = (presets.config2()[0] if which == "config2"
             else presets.rtiow_final_scene(pad_to=512))
    camera = presets.final_scene_camera(64).replace(max_depth=depth)
    cols, attrs, cam_row = mrk.prepare(scene, camera, card)
    n = camera.num_pixels
    kw = dict(bounce_seed=123456, cam_seed=987654, rid_base=5 * n, pix0=0, n_valid=n,
              n_cap=n, w=camera.image_width, max_depth=depth)
    before = mrk.mega_render_cuda.launches
    got, got_b = mrk.mega_render_sample(cols, attrs, cam_row, **kw)
    assert mrk.mega_render_cuda.launches == before + 1
    want, want_b = mrk.mega_render_plain(cols, attrs, cam_row, **kw)
    torch.cuda.synchronize()
    d = (got - want).abs()
    if depth == 1:
        assert float(d.max()) < 1e-6
    assert float(d.mean()) < 5e-6
    assert float((d.max(dim=1).values > 5e-4).float().mean()) <= 0.02
    assert abs(int(got_b) - int(want_b)) <= 0.001 * int(want_b)


def test_kernel_shard_zero_fills_capacity(card):
    scene, camera = presets.config2()
    camera = camera.replace(max_depth=4)
    cols, attrs, cam_row = mrk.prepare(scene, camera, card)
    colors, _ = mrk.mega_render_cuda(cols, attrs, cam_row, bounce_seed=1, cam_seed=2,
                                     rid_base=0, pix0=100, n_valid=300, n_cap=320,
                                     w=camera.image_width, max_depth=4)
    torch.cuda.synchronize()
    assert torch.count_nonzero(colors[300:]) == 0
    assert torch.isfinite(colors).all()


def _fwd_args(scene, camera, card):
    cols, attrs, cam_row = mrk.prepare(scene, camera, card)
    return (cols, attrs, cam_row), dict(bounce_seed=123456, cam_seed=987654, pix0=0,
                                        n_valid=camera.num_pixels, w=camera.image_width,
                                        max_depth=camera.max_depth)


def _written_rows(out):
    """The tape rows the forward wrote, as int32 bits, in (depth, ray) order."""
    depth = torch.arange(out.tape.shape[0], device=out.tape.device)[:, None]
    return out.tape[depth < out.lengths[None, :].long()].view(torch.int32)


@pytest.mark.parametrize("which,depth", [("config2", 8), ("final", 8)])
def test_recording_forward_matches_plain_on_card(card, which, depth):
    scene = (presets.config2()[0] if which == "config2"
             else presets.rtiow_final_scene(pad_to=512))
    camera = presets.final_scene_camera(64).replace(max_depth=depth)
    args, kw = _fwd_args(scene, camera, card)
    before = mk.mega_forward_camera_cuda.launches
    got = mk.mega_forward_camera(*args, None, **kw)
    assert mk.mega_forward_camera_cuda.launches == before + 1
    want = mk.mega_forward_camera_plain(*args, None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.lengths, want.lengths)
    assert torch.equal(_written_rows(got), _written_rows(want))
    assert torch.equal(got.colors, want.colors)
    # at equal seeds the colors are the render kernel's (sample 0)
    k5, _ = mrk.mega_render_cuda(*args, rid_base=0, pix0=0, n_valid=camera.num_pixels,
                                 n_cap=camera.num_pixels, w=camera.image_width,
                                 max_depth=depth, bounce_seed=123456, cam_seed=987654)
    torch.cuda.synchronize()
    assert torch.equal(got.colors, k5)


def test_walk_backward_matches_plain_on_card(card):
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    args, kw = _fwd_args(scene, camera, card)
    out = mk.mega_forward_camera(*args, None, **kw)
    g = torch.randn(camera.num_pixels, 3, generator=torch.Generator().manual_seed(3)).to(card)
    before = wbk.mega_walk_backward_cuda.launches
    got = wbk.mega_walk_backward(out.tape, out.lengths, g, scene.num_spheres)
    assert wbk.mega_walk_backward_cuda.launches == before + 1
    want = wbk.mega_walk_backward_plain(out.tape, out.lengths, g, scene.num_spheres)
    torch.cuda.synchronize()
    n = scene.num_spheres
    scale = want[:n].abs().max(dim=0).values + 1e-8
    # f32 sums in another order (atomics): the band of tests/test_mega_bwd.py:104
    assert float(((got[:n] - want[:n]) / scale).abs().max()) < 1e-4
    assert torch.isfinite(got).all()


def test_tracer_gradients_on_card(card):
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    tracer = make_tape_camera_tracer(camera, 11, 22, iota_pix=True)
    p = {k: v.to(card).requires_grad_() for k, v in scene.diff_params().items()}
    colors = tracer(scene.with_diff_params(p), torch.arange(camera.num_pixels))
    image_loss(colors, torch.zeros_like(colors)).backward()
    for k, v in p.items():
        assert torch.isfinite(v.grad).all(), k
        assert float(v.grad[487:].abs().max()) == 0.0, k  # padding spheres
    assert float(p["albedo"].grad.abs().max()) > 0.0


def _walk_camera(width):
    return presets.make_camera(aspect_ratio=16.0 / 9.0, image_width=width, samples_per_pixel=1,
                               max_depth=8, vfov=55.0, lookfrom=(0.0, 20.0, 60.0),
                               lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0),
                               defocus_angle=0.0, focus_dist=10.0)


def _walk_args(scene, camera, card):
    pack = mwk.walk_pack_for(scene, camera, chunk=256)
    p = pack.to(card)
    return pack, (p.scene_pack, p.attrs, p.bounds, p.chunk_len,
                  camera_scalar_row(camera).to(card).contiguous())


@pytest.mark.parametrize("n", [600, 8192])
def test_walk_matches_plain_on_card(card, n):
    """K9 render and record against their plain versions, bit for bit,
    with the kernel's counters equal to the plain count."""
    scene = presets.random_sphere_field(n, seed=5, extent=30.0)
    camera = _walk_camera(128)
    _, args = _walk_args(scene, camera, card)
    r = camera.num_pixels
    kw = dict(bounce_seed=123456, cam_seed=987654, pix0=0, n_valid=r, w=camera.image_width,
              max_depth=camera.max_depth)
    before = mwk.mega_walk_sample_cuda.launches
    got, got_st = mwk.mega_walk_sample(*args, rid_base=0, n_cap=r, **kw)
    assert mwk.mega_walk_sample_cuda.launches == before + 1
    want, want_st = mwk.mega_walk_sample_plain(*args, rid_base=0, n_cap=r, **kw)
    rec = mwk.mega_walk_forward_camera(*args, **kw)
    rec_plain = mwk.mega_walk_forward_camera_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_st, want_st)
    assert torch.equal(rec.colors, got) and torch.equal(rec.stats, got_st)
    assert torch.equal(rec.lengths, rec_plain.lengths)
    assert torch.equal(_written_rows(rec), _written_rows(rec_plain))


def test_walk_backward_past_512_on_card(card):
    """K8 past 512 slots (8,448: bins past 512 by global atomics) against the plain walk."""
    scene = presets.random_sphere_field(8192, seed=5, extent=30.0)
    camera = _walk_camera(128)
    pack, args = _walk_args(scene, camera, card)
    out = mwk.mega_walk_forward_camera(*args, bounce_seed=11, cam_seed=22, pix0=0,
                                       n_valid=camera.num_pixels, w=camera.image_width,
                                       max_depth=camera.max_depth)
    g = torch.randn(camera.num_pixels, 3, generator=torch.Generator().manual_seed(3)).to(card)
    n = pack.n_slots
    got = wbk.mega_walk_backward(out.tape, out.lengths, g, n)
    want = wbk.mega_walk_backward_plain(out.tape, out.lengths, g, n)
    torch.cuda.synchronize()
    scale = want[:n].abs().max(dim=0).values + 1e-8
    assert float(((got[:n] - want[:n]) / scale).abs().max()) < 1e-4
    assert float(got[n].abs().max()) == 0.0  # the no-hit bin


def test_walk_tracer_gradients_on_card(card):
    scene = presets.random_sphere_field(8192, seed=5, extent=30.0, pad_to=8200)
    camera = _walk_camera(128)
    tracer = make_tape_camera_walk_tracer(camera, 11, 22, scene, chunk=256)
    p = {k: v.to(card).requires_grad_() for k, v in scene.diff_params().items()}
    before = (mwk.mega_walk_forward_camera_cuda.launches, wbk.mega_walk_backward_cuda.launches)
    colors = tracer(scene.with_diff_params(p), torch.arange(camera.num_pixels))
    image_loss(colors, torch.zeros_like(colors)).backward()
    assert (mwk.mega_walk_forward_camera_cuda.launches,
            wbk.mega_walk_backward_cuda.launches) == (before[0] + 1, before[1] + 1)
    for k, v in p.items():
        assert torch.isfinite(v.grad).all(), k
        assert float(v.grad[8193:].abs().max()) == 0.0, k  # absent from the pack
    assert float(p["albedo"].grad.abs().max()) > 0.0


def _col_err(got, want):
    """Per-column max |got - want| over the column's max |want|."""
    return float(((got - want).abs().max(dim=0).values
                  / (want.abs().max(dim=0).values + 1e-8)).max())


def _camera_rays(camera, card):
    pix = torch.arange(camera.num_pixels, device=card)
    return mrk.camera_rays_host(camera_scalar_row(camera).to(card), pix, pix, 987654,
                                camera.image_width)


@pytest.mark.parametrize("which", ["config2", "final"])
def test_ray_mode_forward_matches_plain_on_card(card, which):
    """K6 in ray mode against its plain version, and, fed the rays
    camera_rays_host makes with rid = pix, against K6 in camera mode: tape
    and colors bit for bit."""
    scene = (presets.config2()[0] if which == "config2"
             else presets.rtiow_final_scene(pad_to=512))
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    (cols, attrs, cam_row), kw = _fwd_args(scene, camera, card)
    o, d = _camera_rays(camera, card)
    before = mk.mega_forward_cuda.launches
    got = mk.mega_forward(cols, attrs, o, d, bounce_seed=123456, max_depth=8)
    assert mk.mega_forward_cuda.launches == before + 1
    want = mk.mega_forward_plain(cols, attrs, o, d, bounce_seed=123456, max_depth=8)
    cam_mode = mk.mega_forward_camera(cols, attrs, cam_row, None, **kw)
    torch.cuda.synchronize()
    for other in (want, cam_mode):
        assert torch.equal(got.lengths, other.lengths)
        assert torch.equal(_written_rows(got), _written_rows(other))
        assert torch.equal(got.colors, other.colors)


def test_mega_backward_matches_plain_on_card(card):
    """K7 against its plain version (g_pm and the ray cotangents, per
    column normalized, 1e-4: f32 sums in another order), and against K8
    with ray grads on the same tape (the same walk, the parameters from
    the scene instead of the tape)."""
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    (cols, attrs, _), _ = _fwd_args(scene, camera, card)
    o, d = _camera_rays(camera, card)
    out = mk.mega_forward(cols, attrs, o, d, bounce_seed=123456, max_depth=8)
    g = torch.randn(camera.num_pixels, 3, generator=torch.Generator().manual_seed(3)).to(card)
    n = scene.num_spheres
    before = mbk.mega_backward_cuda.launches
    got_pm, got_ray = mbk.mega_backward(cols, attrs, out.tape, out.lengths, g, n)
    assert mbk.mega_backward_cuda.launches == before + 1
    want_pm, want_ray = mbk.mega_backward_plain(cols, attrs, out.tape, out.lengths, g, n)
    k8_pm, k8_ray = wbk.mega_walk_backward(out.tape, out.lengths, g, n, ray_grads=True)
    torch.cuda.synchronize()
    assert _col_err(got_pm[:n], want_pm[:n]) < 1e-4
    assert _col_err(got_ray, want_ray) < 1e-4
    assert _col_err(got_pm[:n], k8_pm[:n]) < 1e-4
    assert _col_err(got_ray, k8_ray) < 1e-4
    assert torch.isfinite(got_pm).all() and torch.isfinite(got_ray).all()


def test_walk_backward_ray_grads_on_card(card):
    """K8 with ray grads against its plain version; without them it
    returns what the plain walk without ray grads returns."""
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    args, kw = _fwd_args(scene, camera, card)
    out = mk.mega_forward_camera(*args, None, **kw)
    g = torch.randn(camera.num_pixels, 3, generator=torch.Generator().manual_seed(3)).to(card)
    n = scene.num_spheres
    before = wbk.mega_walk_backward_cuda.ray_launches
    got_pm, got_ray = wbk.mega_walk_backward(out.tape, out.lengths, g, n, ray_grads=True)
    assert wbk.mega_walk_backward_cuda.ray_launches == before + 1
    want_pm, want_ray = wbk.mega_walk_backward_plain(out.tape, out.lengths, g, n,
                                                     ray_grads=True)
    plain = wbk.mega_walk_backward(out.tape, out.lengths, g, n)
    torch.cuda.synchronize()
    assert _col_err(got_pm[:n], want_pm[:n]) < 1e-4
    assert _col_err(got_ray, want_ray) < 1e-4
    assert _col_err(plain[:n], want_pm[:n]) < 1e-4


def test_ray_and_pose_tracers_on_card(card):
    """Weights carried over as numpy arrays (Scene.from_numpy, the camera
    by Camera.from_numpy and its row) feed both tracers on the card; their
    colors agree with the same tracers on the CPU and their gradients are
    finite, with the launches each path makes."""
    src = presets.rtiow_final_scene(pad_to=512)
    scene = Scene.from_numpy(src.to_numpy(), card)
    cam0 = presets.final_scene_camera(64).replace(max_depth=8)
    camera = Camera.from_numpy(cam0.to_numpy(), "cpu")
    o, d = _camera_rays(camera, "cpu")
    results = {}
    for dev in (card, torch.device("cpu")):
        s = scene.to(dev)
        p = {k: v.clone().requires_grad_() for k, v in s.diff_params().items()}
        ray_o, ray_d = o.to(dev).requires_grad_(), d.to(dev).requires_grad_()
        before = (mk.mega_forward_cuda.launches, mbk.mega_backward_cuda.launches)
        colors = make_tape_tracer(prng.PRNGKey(4), 8, use_mega=True, mega_bwd=True,
                                  device=dev)(s.with_diff_params(p), ray_o, ray_d)
        image_loss(colors, torch.zeros_like(colors)).backward()
        if dev.type == "cuda":
            assert (mk.mega_forward_cuda.launches, mbk.mega_backward_cuda.launches) == (
                before[0] + 1, before[1] + 1)
        row = camera_scalar_row(camera).to(dev).requires_grad_()
        pose = make_tape_camera_pose_tracer(camera, 123456, 987654, device=dev)
        before = wbk.mega_walk_backward_cuda.ray_launches
        pose_colors = pose(s, row)
        image_loss(pose_colors, torch.zeros_like(pose_colors)).backward()
        if dev.type == "cuda":
            assert wbk.mega_walk_backward_cuda.ray_launches == before + 1
        results[dev.type] = (colors.detach().cpu(), pose_colors.detach().cpu())
        for t in (*p.values(), ray_o, ray_d, row):
            assert torch.isfinite(t.grad).all()
        assert float(row.grad.abs().max()) > 0.0 and float(ray_d.grad.abs().max()) > 0.0
    for got, want in zip(results["cuda"], results["cpu"]):
        dif = (got - want).abs()
        assert float(dif.mean()) < 1.5e-3
        assert float((dif.max(dim=1).values > 5e-4).float().mean()) <= 0.02


def _lanes(n, seed, card, center=(13.0, 2.0, 3.0), spread=0.1):
    """Pool lanes made with numpy: origins around center, directions toward
    the origin plus noise, every third lane inactive, ray ids 7k + 13."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 2 + np.asarray(center)).astype(np.float32)
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True)
         + spread * rng.normal(size=(n, 3))).astype(np.float32)
    act = np.arange(n) % 3 != 2
    rid = (np.arange(n) * 7 + 13).astype(np.int32)
    return tuple(torch.from_numpy(x).to(card) for x in (o, d, act, rid))


def _assert_same_bounce(got, want):
    for k in bk.BounceOut._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("which", ["final512", "field600"])
def test_fused_bounce_matches_plain_on_card(card, which):
    """K10 against its plain version, bit for bit, on the shared-memory
    path (512 spheres) and the global-memory one (601), with hash draws
    and with given draws, counters included."""
    if which == "final512":
        scene, lanes = presets.rtiow_final_scene(pad_to=512), _lanes(4000, 3, card)
    else:
        scene = presets.random_sphere_field(600, seed=7, extent=12.0)
        lanes = _lanes(4000, 4, card, center=(0.0, 6.0, 25.0), spread=0.3)
    arrays = bk.fused_scene_arrays(scene.to(card))
    st_k, st_p = (torch.zeros(4, dtype=torch.int64, device=card) for _ in range(2))
    before = bk.fused_bounce_cuda.launches
    got = bk.fused_bounce(*lanes, arrays, 24680, stats=st_k)
    assert bk.fused_bounce_cuda.launches == before + 1
    want = bk.fused_bounce_plain(*lanes, arrays, 24680, stats=st_p)
    torch.cuda.synchronize()
    _assert_same_bounce(got, want)
    assert torch.equal(st_k, st_p)
    draws = torch.rand(5, 4000, generator=torch.Generator().manual_seed(1)).clamp(1e-7).to(card)
    _assert_same_bounce(bk.fused_bounce(*lanes, arrays, 1, draws=draws),
                        bk.fused_bounce_plain(*lanes, arrays, 1, draws=draws))


def test_culled_fused_bounce_matches_plain_on_card(card):
    """K14 against its plain version and K10 on the culled scene, bit for
    bit, and its counters against the plain walk's count."""
    culled = build_culled_scene(presets.rtiow_final_scene(pad_to=512), chunk=128)
    pack = cb.build_culled_pack(culled).to(card)
    lanes = _lanes(4000, 5, card)
    st_k, st_p = (torch.zeros(4, dtype=torch.int64, device=card) for _ in range(2))
    before = cb.culled_fused_bounce_cuda.launches
    got = cb.culled_fused_bounce(*lanes, pack, 13579, stats=st_k)
    assert cb.culled_fused_bounce_cuda.launches == before + 1
    want = cb.culled_fused_bounce_plain(*lanes, pack, 13579, stats=st_p)
    dense = bk.fused_bounce(*lanes, bk.fused_scene_arrays(culled.scene.to(card)), 13579)
    torch.cuda.synchronize()
    _assert_same_bounce(got, want)
    _assert_same_bounce(got, dense)
    assert torch.equal(st_k, st_p)


# --- the group walk (csrc/trace.cuh group_walk): K14 and K12/K13 run the
# built G lanes per ray.  Held bit for bit to their plain versions on odd
# lane counts (a partial last block and, at G < 32, a partial warp of
# groups), and their counters, the issued slot-test lanes included, to
# the schedule model group_walk_plain at the kernel's G ---


def _group_scene():
    from test_torch_culled_group import CHUNK, _rays, _scene

    scene = _scene()
    return build_culled_scene(scene, chunk=CHUNK), _rays(scene)


@pytest.mark.parametrize("which", ["final128", "synthetic16"])
def test_culled_fused_bounce_group_walk_on_card(card, which):
    """K14 against its plain version (nine outputs and counters, with hash
    draws and with handed-in draws) on 4,001 lanes of the final scene in
    chunks of 128 and the 325 rays of the synthetic scene in chunks of 16
    (ground chunk, twins, grazing rays), every third lane inactive; its
    issued lanes are the model's at the kernel's G."""
    if which == "final128":
        culled = build_culled_scene(presets.rtiow_final_scene(pad_to=512), chunk=128)
        lanes = _lanes(4001, 6, card)
    else:
        culled, (o, d) = _group_scene()
        r = o.shape[0]
        lanes = (o.to(card), d.to(card), (torch.arange(r) % 3 != 2).to(card),
                 (torch.arange(r, dtype=torch.int32) * 7 + 13).to(card))
    pack = cb.build_culled_pack(culled).to(card)
    g, threads = cb.group_shape()
    assert 1 <= g <= 32 and threads % 32 == 0
    st_k, st_p = (torch.zeros(4, dtype=torch.int64, device=card) for _ in range(2))
    issued = torch.zeros(1, dtype=torch.int64, device=card)
    got = cb.culled_fused_bounce_cuda(*lanes, pack, 97531, stats=st_k, issued=issued)
    want = cb.culled_fused_bounce_plain(*lanes, pack, 97531, stats=st_p)
    r = lanes[0].shape[0]
    _, _, n = ck.group_walk_plain(lanes[0], lanes[1], pack.scene_pack, pack.bounds,
                                  torch.arange(pack.n_chunks, device=card).expand(r, -1),
                                  torch.full((r,), pack.n_chunks, device=card), pack.chunk_len,
                                  pack.chunk, g)
    torch.cuda.synchronize()
    _assert_same_bounce(got, want)
    assert torch.equal(st_k, st_p)
    assert int(issued) == n["issued"]
    assert 0.0 < mk.group_lane_use(int(st_k[2]), int(issued)) <= 1.0
    draws = torch.rand(5, r, generator=torch.Generator().manual_seed(2)).clamp(1e-7).to(card)
    _assert_same_bounce(cb.culled_fused_bounce(*lanes, pack, 1, draws=draws),
                        cb.culled_fused_bounce_plain(*lanes, pack, 1, draws=draws))


@pytest.mark.parametrize("mode", ["grid", "walk"])
@pytest.mark.parametrize("which", ["final128", "synthetic16"])
def test_culled_closest_hit_group_walk_on_card(card, which, mode):
    """K12 (grid) and K13 (walk) against their plain version, t and idx bit
    for bit, on 3,001 random rays at the final scene in chunks of 128 and
    the 325 rays of the synthetic scene in chunks of 16 (plan blocks of
    128 rays, the last partial); their counters and issued lanes are the
    model's at the kernel's G."""
    if which == "final128":
        culled = build_culled_scene(presets.rtiow_final_scene(pad_to=512), chunk=128)
        o, d = _lanes(3001, 7, card)[:2]
    else:
        culled, (o, d) = _group_scene()
        o, d = o.to(card), d.to(card)
    csc = culled.scene.to(card)
    sph = ik.sphere_pack(csc.centers, csc.radii)
    bounds = ck.culled_bounds(culled, card)
    r = o.shape[0]
    br, nb = ck.plan_blocks(r, block_rays=ck.LANE)
    order, n_visit = ck.block_visit_plan(o, d, torch.from_numpy(culled.bounds_c).to(card),
                                         torch.from_numpy(culled.bounds_r2).to(card), nb, br)
    launch = ck.culled_closest_hit_walk_cuda if mode == "walk" else ck.culled_closest_hit_cuda
    stats = torch.zeros(len(ck.CULLED_STATS), dtype=torch.int64, device=card)
    issued = torch.zeros(1, dtype=torch.int64, device=card)
    before = launch.launches
    t, idx = launch(o, d, sph, bounds, order, n_visit, culled.chunk, br, stats=stats,
                    issued=issued)
    assert launch.launches == before + 1
    t_p, idx_p = ck.culled_closest_hit_plain(o, d, sph, order, culled.chunk, br)
    block = torch.arange(r, device=card) // br
    n_pos = n_visit.long()[block] if mode == "walk" else torch.full_like(block, order.shape[1])
    lens = torch.full((order.shape[1],), culled.chunk, dtype=torch.int32, device=card)
    t_m, idx_m, n = ck.group_walk_plain(o, d, sph, bounds, order.long()[block], n_pos, lens,
                                        culled.chunk, ck.group_shape()[0])
    torch.cuda.synchronize()
    assert torch.equal(t, t_p) and torch.equal(idx, idx_p)
    assert torch.equal(t_m, t_p) and torch.equal(idx_m, idx_p)
    assert stats.tolist() == [r] + [n[k] for k in ck.CULLED_STATS[1:]]
    assert int(issued) == n["issued"]


# --- the dense group sweep (csrc/trace.cuh group_sweep): K10 and K11 run
# the built G lanes per ray.  Held bit for bit to their plain versions,
# counters included, on lane counts that fill no whole block (and, at
# G < 32, no whole warp of groups), on both of K10's instantiations (the
# scene staged up to 512 spheres, read from global memory above) and on
# the synthetic tie scene of tests/test_torch_dense_scene.py ---


def _dense_scene(which, card):
    """(scene, rays o, d) on the card: the padded final scene with 4,001
    rays, a 601-sphere field with 4,001, bench.py's 8,193-sphere field
    with 3,001 random rays, or the 301-sphere tie scene with its 333."""
    if which == "final512":
        return presets.rtiow_final_scene(pad_to=512), _lanes(4001, 8, card)[:2]
    if which == "field600":
        scene = presets.random_sphere_field(600, seed=7, extent=12.0)
        return scene, _lanes(4001, 9, card, center=(0.0, 6.0, 25.0), spread=0.3)[:2]
    if which == "field8192":
        g = torch.Generator().manual_seed(12)
        o = ((torch.rand(3001, 3, generator=g) * 2.0 - 1.0) * 40.0).to(card)
        d = torch.randn(3001, 3, generator=g).to(card)
        return presets.random_sphere_field(8192, seed=5, extent=30.0), (o, d)
    from test_torch_dense_scene import tie_arrays, tie_rays

    arrays = tie_arrays()
    return Scene.from_numpy(arrays, "cpu"), tuple(torch.from_numpy(x).to(card)
                                                  for x in tie_rays(arrays))


@pytest.mark.parametrize("which", ["final512", "field600", "tie301"])
def test_fused_bounce_group_sweep_on_card(card, which):
    """K10 at its built shape against its plain version (nine outputs and
    the four counters, with hash draws and with handed-in draws), every
    third lane inactive; its winners are the schedule model's at the
    kernel's G."""
    scene, (o, d) = _dense_scene(which, card)
    r = o.shape[0]
    act = (torch.arange(r) % 3 != 2).to(card)
    rid = (torch.arange(r, dtype=torch.int32) * 7 + 13).to(card)
    g, threads = bk.group_shape()
    assert 1 <= g <= 32 and threads % 32 == 0
    arrays = bk.fused_scene_arrays(scene.to(card))
    st_k, st_p = (torch.zeros(4, dtype=torch.int64, device=card) for _ in range(2))
    before = bk.fused_bounce_cuda.launches
    got = bk.fused_bounce(o, d, act, rid, arrays, 86420, stats=st_k)
    assert bk.fused_bounce_cuda.launches == before + 1
    want = bk.fused_bounce_plain(o, d, act, rid, arrays, 86420, stats=st_p)
    sc = scene.to(card)
    _, idx_m, n = ck.group_sweep_plain(o, d, ik.sphere_pack(sc.centers, sc.radii), g)
    torch.cuda.synchronize()
    _assert_same_bounce(got, want)
    assert torch.equal(st_k, st_p)
    assert torch.equal(got.idx, idx_m)
    assert st_k.tolist() == [r, r, n["tests"], n["near"]]
    draws = torch.rand(5, r, generator=torch.Generator().manual_seed(3)).clamp(1e-7).to(card)
    _assert_same_bounce(bk.fused_bounce(o, d, act, rid, arrays, 1, draws=draws),
                        bk.fused_bounce_plain(o, d, act, rid, arrays, 1, draws=draws))


@pytest.mark.parametrize("which", ["final512", "field8192", "tie301"])
def test_closest_hit_group_sweep_on_card(card, which):
    """K11 at its built shape against its plain version on an odd ray
    count: t, idx and the tests with disc >= 0 bit for bit, equal to the
    schedule model's at the kernel's G; the lower twin wins the exact
    ties of the tie scene."""
    scene, (o, d) = _dense_scene(which, card)
    sc = scene.to(card)
    sph = ik.sphere_pack(sc.centers, sc.radii)
    g, threads = ik.group_shape()
    assert 1 <= g <= 32 and threads % 32 == 0
    st_k, st_p = (torch.zeros(1, dtype=torch.int64, device=card) for _ in range(2))
    before = ik.closest_hit_cuda.launches
    t, idx = ik.closest_hit_cuda(o, d, sph, stats=st_k)
    assert ik.closest_hit_cuda.launches == before + 1
    t_p, idx_p = ik.closest_hit_plain(o, d, sph, stats=st_p)
    t_m, idx_m, n = ck.group_sweep_plain(o, d, sph, g)
    torch.cuda.synchronize()
    assert torch.equal(t, t_p) and torch.equal(idx, idx_p)
    assert torch.equal(t_m, t_p) and torch.equal(idx_m, idx_p)
    assert int(st_k) == int(st_p) == n["near"]
    if which == "tie301":
        from test_torch_dense_scene import TWINS

        assert int((idx == TWINS[0]).sum()) >= 10 and not bool((idx == TWINS[1]).any())


def test_fused_engine_on_card(card):
    """The fused engine on the card: with a pool holding every ray it
    equals the mega engine (dense, K5) and the walk (culled, K9) bit for
    bit; at a refilling pool the dense and culled engines agree and a lane
    re-sort changes nothing."""
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    culled = build_culled_scene(scene, chunk=128)
    total = 2 * camera.num_pixels
    kw = dict(device=card)
    mega = mrk.render_wavefront_sum_mega(scene, camera, 2, 11, 22, **kw)
    assert torch.equal(wavefront.render_wavefront_sum_fused(scene, camera, 2, 11, 22,
                                                            pool_size=total, **kw), mega)
    walk = mwk.render_wavefront_sum_mega_walk(mwk.build_walk_pack(culled, camera.center.numpy()),
                                              camera, 2, 11, 22, **kw)
    assert torch.equal(wavefront.render_wavefront_sum_fused(scene, camera, 2, 11, 22,
                                                            pool_size=total, culled=culled, **kw),
                       walk)
    dense = wavefront.render_wavefront_sum_fused(culled.scene, camera, 2, 11, 22, pool_size=512,
                                                 **kw)
    walked = wavefront.render_wavefront_sum_fused(scene, camera, 2, 11, 22, pool_size=512,
                                                  culled=culled, resort_every=2, **kw)
    assert torch.equal(dense, walked)


# --- K5 and K6 as persistent, compacting blocks (csrc/persist.cuh) ---
# A grid of one block makes one pool trace every ray (refilled from the
# counter hundreds of times); the default grid is as many blocks as fit
# the card.  Both must give the plain version's colors, tape rows,
# lengths and bounce count bit for bit.  The final scene at 70x39 has
# 2,730 rays, a multiple of neither 32 nor 256.


def _persist_camera(depth):
    return presets.final_scene_camera(70).replace(max_depth=depth)


@pytest.mark.parametrize("depth", [1, 50])
@pytest.mark.parametrize("grid", [None, 1])
def test_persistent_render_matches_plain_on_card(card, depth, grid):
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = _persist_camera(depth)
    cols, attrs, cam_row = mrk.prepare(scene, camera, card)
    n = camera.num_pixels
    assert n % 32 and n % 256
    kw = dict(bounce_seed=123456, cam_seed=987654, rid_base=3 * n, pix0=0, n_valid=n,
              n_cap=n, w=camera.image_width, max_depth=depth)
    got, got_b, steps = mrk.mega_render_cuda(cols, attrs, cam_row, grid=grid,
                                             with_warp_steps=True, **kw)
    want, want_b = mrk.mega_render_plain(cols, attrs, cam_row, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got_b) == int(want_b)
    assert 0.0 < mk.lane_use(int(got_b), int(steps)) <= 1.0


@pytest.mark.parametrize("max_depth", [0, 8])
def test_persistent_render_shard_on_card(card, max_depth):
    """n_valid < n_cap with a pix0 offset: rows past n_valid are zero, the
    rest the plain version's (all zero at max_depth 0)."""
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = _persist_camera(max(max_depth, 1))
    cols, attrs, cam_row = mrk.prepare(scene, camera, card)
    kw = dict(bounce_seed=5, cam_seed=6, rid_base=(1 << 31) + 17, pix0=100, n_valid=1000,
              n_cap=1300, w=camera.image_width, max_depth=max_depth)
    for grid in (None, 1):
        got, got_b = mrk.mega_render_cuda(cols, attrs, cam_row, grid=grid, **kw)
        want, want_b = mrk.mega_render_plain(cols, attrs, cam_row, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.count_nonzero(got[1000:]) == 0
        assert int(got_b) == int(want_b)


def _persist_forward(mode, scene, camera, card, grid):
    """(K6 out, plain out) in camera mode (iota or explicit pixel ids) or
    ray mode (camera_rays_host's rays of every pixel)."""
    (cols, attrs, cam_row), kw = _fwd_args(scene, camera, card)
    if mode == "ray":
        o, d = _camera_rays(camera, card)
        args = (cols, attrs, o, d)
        fkw = dict(bounce_seed=123456, max_depth=camera.max_depth)
        return mk.mega_forward_cuda(*args, grid=grid, **fkw), mk.mega_forward_plain(*args, **fkw)
    ids = None
    if mode == "ids":  # 1,000 pixels in a scattered order
        ids = torch.randperm(camera.num_pixels, generator=torch.Generator().manual_seed(4))[:1000]
        ids = ids.to(torch.int32).to(card)
        kw["n_valid"] = 1000
    return (mk.mega_forward_camera_cuda(cols, attrs, cam_row, ids, grid=grid, **kw),
            mk.mega_forward_camera_plain(cols, attrs, cam_row, ids, **kw))


@pytest.mark.parametrize("mode", ["iota", "ids", "ray"])
@pytest.mark.parametrize("depth", [1, 50])
@pytest.mark.parametrize("grid", [None, 1])
def test_persistent_forward_matches_plain_on_card(card, mode, depth, grid):
    scene = presets.rtiow_final_scene(pad_to=512)
    got, want = _persist_forward(mode, scene, _persist_camera(depth), card, grid)
    torch.cuda.synchronize()
    assert torch.equal(got.lengths, want.lengths)
    assert torch.equal(_written_rows(got), _written_rows(want))
    assert torch.equal(got.colors, want.colors)
    assert int(got.bounces) == int(want.bounces) == int(got.lengths.sum())
    assert 0.0 < mk.lane_use(int(got.bounces), int(got.warp_steps)) <= 1.0


def test_persistent_lane_use_on_card(card):
    """The persistent loop keeps more lanes busy than static warps of 32
    consecutive rays would on the same rays (final scene 240x135, depth
    50), and K5 and K6 count the same bounces."""
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(240)
    (cols, attrs, cam_row), kw = _fwd_args(scene, camera, card)
    out = mk.mega_forward_camera_cuda(cols, attrs, cam_row, None, **kw)
    colors, bounces, steps = mrk.mega_render_cuda(
        cols, attrs, cam_row, rid_base=0, n_cap=camera.num_pixels, with_warp_steps=True,
        **kw)
    torch.cuda.synchronize()
    assert torch.equal(colors, out.colors) and int(bounces) == int(out.bounces)
    static = mk.static_lane_use(out.lengths)
    for b, s in ((bounces, steps), (out.bounces, out.warp_steps)):
        assert static < mk.lane_use(int(b), int(s)) <= 1.0


# K9 and the reverse walks K8 and K7 on the same persistent loop: bit for
# bit (K9) or within the f32 sum-order band (K8, K7) of their plain
# versions at the occupancy grid and at one block.


@pytest.mark.parametrize("grid", [None, 1])
def test_persistent_walk_matches_plain_on_card(card, grid):
    """K9 render and record on the 8,192-sphere field: colors, tape rows,
    lengths and the per-lane counters equal to the plain versions'; the
    warp counters give lane uses in (0, 1]."""
    scene = presets.random_sphere_field(8192, seed=5, extent=30.0)
    camera = _walk_camera(120)
    _, args = _walk_args(scene, camera, card)
    r = camera.num_pixels
    kw = dict(bounce_seed=123456, cam_seed=987654, pix0=0, n_valid=r, w=camera.image_width,
              max_depth=camera.max_depth)
    got, got_st, warp = mwk.mega_walk_sample_cuda(*args, rid_base=5 * r, n_cap=r, grid=grid,
                                                  with_warp_stats=True, **kw)
    want, want_st = mwk.mega_walk_sample_plain(*args, rid_base=5 * r, n_cap=r, **kw)
    rec = mwk.mega_walk_forward_camera_cuda(*args, grid=grid, **kw)
    rec_plain = mwk.mega_walk_forward_camera_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_st, want_st)
    assert torch.equal(rec.lengths, rec_plain.lengths)
    assert torch.equal(_written_rows(rec), _written_rows(rec_plain))
    assert torch.equal(rec.colors, rec_plain.colors) and torch.equal(rec.stats, rec_plain.stats)
    for st, ws in ((got_st, warp), (rec.stats, rec.warp_stats)):
        assert 0.0 < mk.lane_use(int(st[0]), int(ws[0])) <= 1.0
        assert 1 / 32 <= mk.sweep_lane_use(int(st[2]), int(ws[1])) <= 1.0


@pytest.mark.parametrize("max_depth", [0, 8])
def test_persistent_walk_shard_on_card(card, max_depth):
    """K9 render with n_valid < n_cap and a pix0 offset: rows past n_valid
    are zero, the rest the plain version's (all zero at max_depth 0)."""
    scene = presets.random_sphere_field(600, seed=5, extent=30.0)
    camera = _walk_camera(64).replace(max_depth=max(max_depth, 1))
    _, args = _walk_args(scene, camera, card)
    kw = dict(bounce_seed=5, cam_seed=6, rid_base=(1 << 31) + 17, pix0=100, n_valid=1000,
              n_cap=1300, w=camera.image_width, max_depth=max_depth)
    for grid in (None, 1):
        got, got_st = mwk.mega_walk_sample_cuda(*args, grid=grid, **kw)
        want, want_st = mwk.mega_walk_sample_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_st, want_st)
        assert torch.count_nonzero(got[1000:]) == 0


def _walk_g(r, card):
    """g_color with every tenth ray's cotangent zero (dropped at refill)."""
    g = torch.randn(r, 3, generator=torch.Generator().manual_seed(3))
    g[::10] = 0.0
    return g.to(card)


@pytest.mark.parametrize("ray_grads", [False, True])
@pytest.mark.parametrize("grid", [None, 1])
def test_persistent_walk_backward_on_card(card, ray_grads, grid):
    """K8 on a dense tape (final scene, depth 8) and on a walk tape past
    512 slots against its plain version (1e-4 per column, the band of
    tests/test_mega_bwd.py:104; with ray grads also the ray cotangents),
    fed in index order and longest first; the rows walked and the ray
    cotangents do not depend on the grid or the order."""
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    args, kw = _fwd_args(scene, camera, card)
    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    wcam = _walk_camera(96)
    pack, wargs = _walk_args(field, wcam, card)
    for out, n in ((mk.mega_forward_camera(*args, None, **kw), scene.num_spheres),
                   (mwk.mega_walk_forward_camera(*wargs, bounce_seed=11, cam_seed=22, pix0=0,
                                                 n_valid=wcam.num_pixels, w=wcam.image_width,
                                                 max_depth=8), pack.n_slots)):
        g = _walk_g(out.lengths.shape[0], card)
        want = wbk.mega_walk_backward_plain(out.tape, out.lengths, g, n, ray_grads=ray_grads)
        want = want if ray_grads else (want,)
        runs = []
        index = torch.arange(out.lengths.shape[0], dtype=torch.int32, device=card)
        for order in (index, None):  # index order, then the default: longest first
            *got, st = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n,
                                                   ray_grads=ray_grads, grid=grid, order=order,
                                                   with_stats=True)
            torch.cuda.synchronize()
            assert _col_err(got[0][:n], want[0][:n]) < 1e-4
            assert float(got[0][n].abs().max()) == 0.0  # the no-hit bin
            if ray_grads:
                assert _col_err(got[1], want[1]) < 1e-4
            assert 0.0 < mk.lane_use(int(st[0]), int(st[1])) <= 1.0
            runs.append((got, int(st[0])))
        assert runs[0][1] == runs[1][1]
        if ray_grads:
            assert torch.equal(runs[0][0][1], runs[1][0][1])


@pytest.mark.parametrize("grid", [None, 1])
def test_persistent_mega_backward_on_card(card, grid):
    """K7 against its plain version (1e-4 per column) and against K8 with
    ray grads on the same tape: equal ray cotangents and rows walked."""
    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    (cols, attrs, _), _ = _fwd_args(scene, camera, card)
    o, d = _camera_rays(camera, card)
    out = mk.mega_forward(cols, attrs, o, d, bounce_seed=123456, max_depth=8)
    g = _walk_g(camera.num_pixels, card)
    n = scene.num_spheres
    got_pm, got_ray, st = mbk.mega_backward_cuda(cols, attrs, out.tape, out.lengths, g, n,
                                                 grid=grid, with_stats=True)
    want_pm, want_ray = mbk.mega_backward_plain(cols, attrs, out.tape, out.lengths, g, n)
    k8_pm, k8_ray, k8_st = wbk.mega_walk_backward_cuda(out.tape, out.lengths, g, n,
                                                       ray_grads=True, grid=grid,
                                                       with_stats=True)
    torch.cuda.synchronize()
    assert _col_err(got_pm[:n], want_pm[:n]) < 1e-4
    assert _col_err(got_ray, want_ray) < 1e-4
    assert torch.equal(got_ray, k8_ray) and int(st[0]) == int(k8_st[0])
    assert _col_err(got_pm[:n], k8_pm[:n]) < 1e-4


def _grads_of(tracer, scene, o, d):
    """(colors, the five fields' gradients) of image_loss against zeros."""
    p = {k: v.detach().clone().requires_grad_() for k, v in scene.diff_params().items()}
    colors = tracer(scene.with_diff_params(p), o, d)
    image_loss(colors, torch.zeros_like(colors)).backward()
    return colors.detach(), {k: v.grad for k, v in p.items()}


def _fields_close(got, want, band):
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= band * (float(w.abs().max()) + 1e-30), k


@pytest.mark.parametrize("kernel", ["k11", "k10", "k12", "k13"])
def test_host_tape_tracer_on_card(card, kernel, monkeypatch):
    """make_tape_tracer(use_mega=False) on the card with each kernel on its
    path (K11 as intersect_fn, K10 with use_fused, K12/K13 through
    make_culled_intersect) against the same step with the kernel's plain
    version on the card: colors bit for bit, one launch per tape row,
    gradients within 1e-4 of each field's max (index_add_'s atomics)."""
    from distributed_raytracer_tpu_torch.grad import tapegrad as ttg

    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    o, d = _camera_rays(camera, card)
    kw = dict(max_depth=8, pool=512, refill_every=2)
    if kernel == "k11":
        counter, kw["intersect_fn"] = ik.closest_hit_cuda, ik.closest_hit_pallas
        plain = (ik, "closest_hit_dense", ik.closest_hit_plain)
    elif kernel == "k10":
        counter, kw["use_fused"] = bk.fused_bounce_cuda, True
        plain = (ttg, "fused_bounce", bk.fused_bounce_plain)
    else:
        culled = build_culled_scene(scene, chunk=128)
        scene = culled.scene
        mode = "grid" if kernel == "k12" else "walk"
        counter = ck.culled_closest_hit_cuda if mode == "grid" else ck.culled_closest_hit_walk_cuda
        kw["intersect_fn"] = ck.make_culled_intersect(culled, mode=mode)
    s = scene.to(card)
    before = counter.launches
    got, g_got = _grads_of(make_tape_tracer(prng.PRNGKey(1), device=card, **kw), s, o, d)
    _, _, n_it, _ = ttg._forward_tape(s, o, d, prng.PRNGKey(1), 8, 512,
                                      **{k: v for k, v in kw.items() if k not in (
                                          "max_depth", "pool")})
    assert counter.launches - before == 2 * n_it  # the step's forward, then this one
    if kernel in ("k12", "k13"):
        monkeypatch.setattr(ck, counter.__name__,
                            lambda o, d, sph, bnd, order, nv, chunk, br:
                            ck.culled_closest_hit_plain(o, d, sph, order, chunk, br))
        kw["intersect_fn"] = ck.make_culled_intersect(culled, mode=mode)
    else:
        monkeypatch.setattr(plain[0], plain[1], plain[2])
    before = counter.launches
    want, g_want = _grads_of(make_tape_tracer(prng.PRNGKey(1), device=card, **kw), s, o, d)
    assert counter.launches == before
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    _fields_close(g_got, g_want, 1e-4)


@pytest.mark.parametrize("primal", ["scan", "wavefront", "fused"])
def test_pathgrad_tracer_on_card(card, primal):
    """make_pathgrad_tracer on the card (K11, or K10 with primal="fused")
    against the same tracer on the CPU: colors at the depth-8 band on 99%
    of the rays (a path rounded apart on the card re-scatters), gradients
    finite; the wavefront primal equals the scan primal bit for bit."""
    from distributed_raytracer_tpu_torch import make_pathgrad_tracer

    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    o, d = _camera_rays(camera, "cpu")
    out = {}
    for dev in (card, torch.device("cpu")):
        tr = make_pathgrad_tracer(prng.PRNGKey(1), 8, intersect_fn=ik.closest_hit_pallas,
                                  primal=primal, primal_pool=1024, device=dev)
        counter = bk.fused_bounce_cuda if primal == "fused" else ik.closest_hit_cuda
        before = counter.launches
        colors, grads = _grads_of(tr, scene.to(dev), o.to(dev), d.to(dev))
        if dev.type == "cuda":
            assert counter.launches > before
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        out[dev.type] = colors.cpu()
    close = (out["cuda"] - out["cpu"]).abs().max(dim=1).values < 5e-4
    assert float(close.float().mean()) >= 0.99
    if primal == "wavefront":
        scan = make_pathgrad_tracer(prng.PRNGKey(1), 8, intersect_fn=ik.closest_hit_pallas,
                                    device=card)
        assert torch.equal(scan(scene.to(card), o.to(card), d.to(card)).cpu(), out["cuda"])


def test_mega_tracer_plain_backward_on_card(card):
    """make_tape_tracer(use_mega=True, mega_bwd=False) (K6, then the plain
    walk on the card) against mega_bwd=True (K6, then K7): equal colors,
    gradients within K7's band (1e-4 of each field's max)."""
    scene = presets.rtiow_final_scene(pad_to=512).to(card)
    camera = presets.final_scene_camera(64).replace(max_depth=8)
    o, d = _camera_rays(camera, card)
    runs = [_grads_of(make_tape_tracer(prng.PRNGKey(3), 8, use_mega=True, mega_bwd=mb,
                                       device=card), scene, o, d) for mb in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    _fields_close(runs[0][1], runs[1][1], 1e-4)


# ---- the distributed layer's kernels at shard offsets (parallel/) ----

DP_RANKS = 3


def _dp_mesh():
    from distributed_raytracer_tpu_torch.parallel import Mesh

    return Mesh(n_rays=DP_RANKS)


def test_mega_dp_render_shards_on_card(card):
    """K5 over 3 ranks of a 50x28 image (1,400 pixels: shards of 467, the
    last 466, so its n_valid < n_cap at a nonzero pix0): the shards
    concatenate to the whole image's sum bit for bit, one launch a sample
    a rank."""
    from distributed_raytracer_tpu_torch.parallel import make_mega_dp_render

    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(50).replace(max_depth=8)
    whole = mrk.render_wavefront_sum_mega(scene, camera, 2, 5, 6, device=card)
    dp = make_mega_dp_render(_dp_mesh(), camera, device=card)
    before = mrk.mega_render_cuda.launches
    got = torch.cat([dp.local(scene, 5, 6, [0, 1], r) for r in range(DP_RANKS)])
    torch.cuda.synchronize()
    assert mrk.mega_render_cuda.launches == before + 2 * DP_RANKS
    assert torch.equal(got[:camera.num_pixels], whole) and not got[camera.num_pixels:].any()


def test_mega_walk_dp_render_shards_on_card(card):
    """K9 over 3 ranks past 512 spheres: the shards equal the whole."""
    from distributed_raytracer_tpu_torch.parallel import make_mega_walk_dp_render

    scene = presets.random_sphere_field(600, seed=5, extent=30.0)
    camera = _walk_camera(50)
    pack = mwk.walk_pack_for(scene, camera, chunk=256)
    whole = mwk.render_wavefront_sum_mega_walk(pack, camera, 2, 5, 6, device=card)
    dp = make_mega_walk_dp_render(_dp_mesh(), pack, camera, device=card)
    before = mwk.mega_walk_sample_cuda.launches
    got = torch.cat([dp.local(5, 6, [0, 1], r) for r in range(DP_RANKS)])
    torch.cuda.synchronize()
    assert mwk.mega_walk_sample_cuda.launches == before + 2 * DP_RANKS
    assert torch.equal(got[:camera.num_pixels], whole)


def test_camera_dp_tracer_shards_on_card(card):
    """K6 and K8 over 3 ranks of the 50x28 image: colors bit for bit with
    the single-device tracer, the summed gradients within 1e-4 of each
    field's max (the same sums, atomics in another order)."""
    from distributed_raytracer_tpu_torch.parallel import make_tape_camera_dp_tracer

    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(50).replace(max_depth=8)
    n = camera.num_pixels

    def leaves():
        return {k: v.to(card).clone().requires_grad_() for k, v in scene.diff_params().items()}

    p = leaves()
    want = make_tape_camera_tracer(camera, 7, 8, iota_pix=True, device=card)(
        scene.with_diff_params(p), torch.arange(n))
    (want ** 2).sum().backward()
    dp = make_tape_camera_dp_tracer(_dp_mesh(), camera, 7, 8, device=card)
    q = leaves()
    before = (mk.mega_forward_camera_cuda.launches, wbk.mega_walk_backward_cuda.launches)
    parts = [dp.local(scene.with_diff_params(q), r) for r in range(DP_RANKS)]
    sum((x ** 2).sum() for x in parts).backward()
    torch.cuda.synchronize()
    assert (mk.mega_forward_camera_cuda.launches, wbk.mega_walk_backward_cuda.launches) == (
        before[0] + DP_RANKS, before[1] + DP_RANKS)
    assert torch.equal(torch.cat(parts)[:n].detach(), want.detach())
    _fields_close({k: v.grad for k, v in q.items()}, {k: v.grad for k, v in p.items()}, 1e-4)


def test_scene_sharded_closest_hit_on_card(card, tmp_path):
    """K11 over 2 scene shards, as a 2-process gloo job on the card
    (tests/_torch_multihost_worker.py): the least hit over the shards
    equals the dense K11 hit on the padded unsplit scene, t and idx bit for
    bit."""
    import subprocess
    import sys
    from pathlib import Path

    from distributed_raytracer_tpu_torch.parallel import shard_scene

    worker = Path(__file__).resolve().parent / "_torch_multihost_worker.py"
    procs = [subprocess.Popen([sys.executable, str(worker), "k11_scene_shards", str(r), "2",
                               str(tmp_path / "init"), str(tmp_path), "cuda"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    sys.path.insert(0, str(worker.parent))
    import _torch_multihost_worker as w

    o, d = w.k11_rays(card)
    padded = shard_scene(presets.rtiow_final_scene(pad_to=512).to(card), 2)
    dense = ik.closest_hit_pallas(o, d, padded)
    for r in range(2):
        got = np.load(tmp_path / f"k11_scene_shards_{r}.npz")
        assert np.array_equal(got["t"].view(np.int32), dense.t.cpu().numpy().view(np.int32))
        assert np.array_equal(got["idx"], dense.idx.cpu().numpy())


def test_shuffled_fill_k10_chunks_on_card(card, monkeypatch):
    """The mega engine's shuffled fill on the final scene at 160x90 depth
    50: every fill chunk runs K10 (pool 2048), and the fill equals the same
    fill with the plain bounce swapped in, bit for bit; samples 1-2 equal
    K5 at batch_seeds(seed, 1)."""
    from distributed_raytracer_tpu_torch.render import progressive

    scene = presets.rtiow_final_scene(pad_to=512)
    camera = presets.final_scene_camera(160)
    kw = dict(seed=5, spp=3, batch=2, fill="shuffled", fill_chunk=4000, engine="mega")
    snaps = []
    before = bk.fused_bounce_cuda.launches
    got = progressive.render_progressive(scene, camera, fill_cb=lambda im: snaps.append(im),
                                         **kw)
    assert bk.fused_bounce_cuda.launches > before
    assert len(snaps) == -(-camera.num_pixels // 4000)
    filled = [int((s.reshape(-1, 3).sum(-1) != 0).sum()) for s in snaps]
    assert filled == sorted(filled)

    def plain(o, d, live, lane_ray, arrays, seed, **k):
        return bk.fused_bounce_plain(o, d, live, lane_ray, arrays, seed, **k)

    monkeypatch.setattr(wavefront, "fused_bounce", plain)
    plain_snaps = []
    want = progressive.render_progressive(scene, camera,
                                          fill_cb=lambda im: plain_snaps.append(im), **kw)
    np.testing.assert_array_equal(snaps[-1], plain_snaps[-1])
    tail = mrk.render_wavefront_sum_mega(scene, camera, 2, *progressive.batch_seeds(5, 1))
    fill = snaps[-1].reshape(-1, 3)
    np.testing.assert_array_equal(got.raw_sum, fill + tail.cpu().numpy())
    np.testing.assert_array_equal(got.raw_sum, want.raw_sum)


def test_resume_jax_mega_checkpoint_on_card(card, tmp_path):
    """The JAX package's committed mega checkpoint (config4, 1200x675, 500
    spp in batches of 50) resumes on the card to 504 spp: the new sum is
    the old sum plus K5's 4-spp sum at batch_seeds(0, 500), bit for bit."""
    import shutil
    from pathlib import Path

    from distributed_raytracer_tpu_torch.render import progressive

    src = Path(__file__).resolve().parents[1] / "artifacts" / "config4_500spp_mega.ckpt"
    ckpt = tmp_path / "resume.ckpt"
    shutil.copyfile(src, ckpt)  # the resume rewrites its checkpoint
    old = progressive.AccumState.load(str(ckpt))
    scene, camera = presets.config4()
    before = mrk.mega_render_cuda.launches
    st = progressive.render_progressive(scene, camera, seed=0, spp=504, batch=50,
                                        engine="mega", checkpoint_path=str(ckpt))
    assert mrk.mega_render_cuda.launches == before + 4
    assert st.samples_done == 504
    delta = mrk.render_wavefront_sum_mega(scene, camera, 4, *progressive.batch_seeds(0, 500))
    np.testing.assert_array_equal(st.raw_sum, old.raw_sum + delta.cpu().numpy())


@pytest.mark.parametrize("engine", ["mega", "walk", "fused"])
def test_progressive_lookahead_on_card(card, tmp_path, monkeypatch, engine):
    """render_progressive on the card: the mega engine (mega: K5 on the
    final scene; walk: K9 on 600 spheres) queues batch k+1 before it hands
    out batch k; the fused engine (K10 on the final scene), which reads
    back inside each batch, hands out batch k first.  On each the image and
    every snapshot equal the float32 prefix sums, added on the host, of the
    engine's own batch sums; each snapshot is its own array, unchanged
    after later batches; the checkpoint after every batch loads to the
    snapshot, one from the middle resumes to the same image bit for bit,
    and a launch that raises leaves the batch before it saved."""
    from distributed_raytracer_tpu_torch.render import progressive

    if engine == "walk":
        scene, camera = presets.random_sphere_field(600, seed=5, extent=30.0), _walk_camera(96)
        pack = mwk.walk_pack_for(scene, camera, chunk=256).to(card)

        def batch_sum(n, seeds):
            return mwk.render_wavefront_sum_mega_walk(pack, camera, n, *seeds, device=card)
    else:
        scene = presets.rtiow_final_scene(pad_to=512)
        camera = presets.final_scene_camera(96).replace(max_depth=50)
        if engine == "mega":
            def batch_sum(n, seeds):
                return mrk.render_wavefront_sum_mega(scene, camera, n, *seeds, device=card)
        else:
            def batch_sum(n, seeds):
                return wavefront.render_wavefront_sum_fused(scene, camera, n, *seeds,
                                                            pool_size=wavefront.DEFAULT_POOL,
                                                            device=card)
    seed, spp, batch = 9, 7, 2
    starts = list(range(0, spp, batch))
    want, acc = [], np.zeros((camera.num_pixels, 3), np.float32)
    for done in starts:  # the expression the loop had: raw_sum + delta on the host
        acc = acc + batch_sum(min(batch, spp - done), progressive.batch_seeds(seed, done)
                              ).cpu().numpy()
        want.append(acc)
    kw = dict(seed=seed, spp=spp, batch=batch, engine="fused" if engine == "fused" else "mega")
    ckpt, middle = tmp_path / "ck.npz", tmp_path / "middle.npz"
    snaps, events = [], []
    name = {"mega": "render_wavefront_sum_mega", "walk": "render_wavefront_sum_mega_walk",
            "fused": "render_wavefront_sum_fused"}[engine]
    engine_sum = getattr(progressive, name)

    def logged(*args, **kwargs):
        events.append("render")
        return engine_sum(*args, **kwargs)

    def keep(state):
        events.append("cb")
        snaps.append(state.raw_sum)
        back = progressive.AccumState.load(str(ckpt))
        assert back.samples_done == state.samples_done
        np.testing.assert_array_equal(back.raw_sum, state.raw_sum)
        if len(snaps) == 2:
            middle.write_bytes(ckpt.read_bytes())

    monkeypatch.setattr(progressive, name, logged)
    before = progressive.render_progressive.overlapped
    got = progressive.render_progressive(scene, camera, checkpoint_path=str(ckpt),
                                         progress_cb=keep, **kw)
    if engine == "fused":
        assert progressive.render_progressive.overlapped == before
        assert events == ["render", "cb"] * len(starts)
    else:
        assert progressive.render_progressive.overlapped == before + len(starts) - 1
        assert events == ["render"] + ["render", "cb"] * (len(starts) - 1) + ["cb"]
    assert len(snaps) == len(starts)
    assert len({id(s) for s in snaps}) == len(snaps)
    for s, w in zip(snaps, want):
        np.testing.assert_array_equal(s, w)
    np.testing.assert_array_equal(got.raw_sum, want[-1])
    assert got.samples_done == spp
    resumed = progressive.render_progressive(scene, camera, checkpoint_path=str(middle), **kw)
    assert resumed.samples_done == spp
    np.testing.assert_array_equal(resumed.raw_sum, want[-1])

    calls = []

    def failing(*args, **kwargs):
        calls.append(args)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return engine_sum(*args, **kwargs)

    monkeypatch.setattr(progressive, name, failing)
    lost = tmp_path / "lost.npz"
    with pytest.raises(RuntimeError, match="launch failed"):
        progressive.render_progressive(scene, camera, checkpoint_path=str(lost), **kw)
    back = progressive.AccumState.load(str(lost))
    assert back.samples_done == starts[2]
    np.testing.assert_array_equal(back.raw_sum, want[1])
