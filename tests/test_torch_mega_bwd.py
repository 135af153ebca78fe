"""The port's ray-table gradient path (plain versions, CPU) against the JAX
package: the recording forward in ray mode against mega_forward, the dense
reverse walk (K7's plain version) against mega_backward on JAX's own tape,
and the tracer end to end against make_tape_tracer(use_mega=True,
mega_bwd=True), at tests/test_mega_bwd.py:27-46's shape (4 spheres, 16x16,
depth 6, generate_rays with PRNGKey(7), key PRNGKey(2)); the rays go to
both sides as numpy.  JAX's kernels run once per module, in interpret mode.

Bands: tape ints equal, floats as tests/test_torch_tapegrad.py holds the
camera tape (the rays are the same floats here, so the depth-0 rows'
o, d and atten are equal); colors at the North-star depth-8 band (max 5e-4, mean 5e-6);
gradients per column of g_pm (and per component of the ray cotangents),
normalized by the column's largest value, at test_mega_bwd.py:153,172-178's
1e-4.  That band is set for the rays without a grazing hit (test_torch_
tapegrad._grazing_rays; ROADMAP Queue 3); at this shape one ray of 256 has
one, and every ray, that one included, stays within it (measured 8.2e-6
for K7 on JAX's tape, 7.6e-6 for the tracer), so every ray is held to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.grad import tapegrad as jtg
from distributed_raytracer_tpu.ops.camera import generate_rays
from distributed_raytracer_tpu.ops.pallas.bounce_kernel import _auto_chunk
from distributed_raytracer_tpu.ops.pallas.mega_bwd_kernel import mega_backward as jax_backward
from distributed_raytracer_tpu.ops.pallas.mega_kernel import mega_forward as jax_forward
from distributed_raytracer_tpu.ops.pallas.mega_kernel import scene_sweep_arrays as jax_arrays
from distributed_raytracer_tpu_torch import make_tape_camera_tracer, make_tape_tracer
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.grad.tapegrad import replay_from_tape
from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row, make_camera
from distributed_raytracer_tpu_torch.ops.kernels import mega_bwd_kernel as mbk
from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_bwd_kernel as wbk
from test_mega_bwd import _scene_cam
from test_torch_scene import to_port
from test_torch_tapegrad import (
    FIELDS,
    INT_COLS,
    _col_err,
    _grazing_rays,
    _pm,
    _to_port_tape,
    _written,
)

torch.set_num_threads(1)


class _Packed:
    """JAX's ray-mode tape (f32 [T, 16, B] and i32 [T, 8, B]) in the
    packed [T, 32, B] layout of the camera tape, for _to_port_tape: the
    int planes at T_IDX, T_RAY, T_FLG, no winner parameters."""

    def __init__(self, out):
        tf = np.asarray(out.tape_f)
        packed = np.zeros((tf.shape[0], 32, tf.shape[2]), np.float32)
        packed[:, :16] = tf
        packed[:, mk.T_IDX:mk.T_FLG + 1] = np.asarray(out.tape_i)[:, 0:3].view(np.float32)
        self.tape_f, self.n_it = packed, out.n_it


@pytest.fixture(scope="module")
def case():
    """Both sides on the same scene, rays and seed; JAX's recording
    forward, its backward on that tape and its tracer's VJP, each run
    once."""
    scene, cam = _scene_cam()
    r = cam.num_pixels
    ids = jnp.arange(r, dtype=jnp.int32)
    o, d = generate_rays(cam, jax.random.PRNGKey(7), ids % 16, ids // 16)
    o, d = np.array(o), np.array(d)  # writable copies, for torch.from_numpy
    key = jax.random.PRNGKey(2)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1, dtype=jnp.int32))
    gc = np.random.default_rng(3).normal(size=(r, 3)).astype(np.float32)

    ts = to_port(scene)
    cols, attrs = mrk.scene_sweep_arrays(ts)
    port = mk.mega_forward(cols, attrs, torch.from_numpy(o), torch.from_numpy(d),
                           bounce_seed=seed, max_depth=cam.max_depth)
    grazing = _grazing_rays(port.tape, port.lengths)

    params = {k: getattr(scene, k) for k in FIELDS}
    f_meg = jtg.make_tape_tracer(key, cam.max_depth, pool=128, use_mega=True, mega_bwd=True)
    _, j_attrs = jax_arrays(scene, _auto_chunk(scene.num_spheres))
    with pltpu.force_tpu_interpret_mode():
        out = jax_forward(scene, jnp.asarray(o), jnp.asarray(d), jnp.int32(seed), cam.max_depth,
                          pool=128)
        k7 = jax_backward(out.tape_f, out.tape_i, out.n_it, jnp.asarray(gc), j_attrs,
                          n=scene.num_spheres)
        colors, vjp = jax.vjp(lambda p, oo, dd: f_meg(scene.replace(**p), oo, dd), params,
                              jnp.asarray(o), jnp.asarray(d))
        tr = vjp(jnp.asarray(gc))
        jax.block_until_ready((k7, tr))
    # the backward's dense ray rows, gathered at each ray's refill position
    b = out.tape_f.shape[2]
    rpos = np.asarray(out.rpos_cb).reshape(-1)[:r]

    def ray_rows(dd):
        flat = np.asarray(dd)[:, 0:6, :].transpose(0, 2, 1).reshape(-1, 6)
        return np.where((rpos >= 0)[:, None], flat[np.clip(rpos, 0, flat.shape[0] - 1)], 0.0)

    assert b == 128
    return dict(scene=scene, cam=cam, ts=ts, cols=cols, attrs=attrs, o=o, d=d, seed=seed, gc=gc,
                grazing=grazing, port=port, jout=out, j_colors=np.asarray(colors),
                j_k7=(np.asarray(k7[0])[:scene.num_spheres], ray_rows(k7[1])),
                j_tr=(_pm(tr[0]), np.concatenate([np.asarray(tr[1]), np.asarray(tr[2])], 1)))


def _port_tracer_grads(c, g, ray_grads=True):
    """The port's tracer on the CPU: colors, g_pm [n, 9] and the ray
    cotangents [R, 6] of sum(colors * g)."""
    tr = make_tape_tracer(prng.PRNGKey(2), c["cam"].max_depth, use_mega=True, mega_bwd=True,
                          ray_grads=ray_grads, device="cpu")
    p = {k: getattr(c["ts"], k).clone().requires_grad_() for k in FIELDS}
    o = torch.from_numpy(c["o"]).requires_grad_()
    d = torch.from_numpy(c["d"]).requires_grad_()
    colors = tr(c["ts"].with_diff_params(p), o, d)
    (colors * torch.from_numpy(g)).sum().backward()
    g_ray = torch.cat([o.grad, d.grad], 1).numpy()
    return colors.detach().numpy(), _pm({k: v.grad for k, v in p.items()}), g_ray


def test_ray_mode_forward_matches_jax(case):
    c = case
    r, depth = c["o"].shape[0], c["cam"].max_depth
    tape, lengths = _to_port_tape(_Packed(c["jout"]), r, depth)
    port = c["port"]
    assert torch.equal(port.lengths, lengths)
    got, want = _written(port.tape, port.lengths), _written(tape, lengths)
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    for col in INT_COLS:
        assert torch.equal(gi[:, col], wi[:, col]), col
    dif = (got - want).abs()[:, :mk.T_CO + 3]  # JAX's ray-mode tape holds no parameters
    n0 = int((lengths > 0).sum())  # the depth-0 rows come first: the given rays
    assert float(dif[:n0, :mk.T_AT + 3].max()) == 0.0, float(dif[:n0, :mk.T_AT + 3].max())
    assert float(dif[:n0].max()) < 1e-6, float(dif[:n0].max())
    row_max = dif.max(dim=1).values
    assert float((row_max > 5e-4).float().mean()) <= 0.01, float(row_max.max())
    assert float(dif.mean()) < 5e-6, float(dif.mean())
    # the port records the winner's parameters in ray mode too: the
    # scene's values at the recorded index on hit rows, zeros on a miss
    hit = (gi[:, mk.T_FLG] & mk.F_HIT) != 0
    idx = gi[:, mk.T_IDX].long()
    w = c["attrs"][:, idx].T
    assert torch.equal(got[hit, mk.T_CW:mk.T_MT + 1], w[hit, 0:10])
    assert not bool(got[~hit, mk.T_CW:mk.T_MT + 1].any())
    d = np.abs(port.colors.numpy() - c["j_colors"])
    print(f"colors vs JAX's tracer: max {d.max():.3g}, mean {d.mean():.3g}")
    assert d.max() < 5e-4 and d.mean() < 5e-6


def test_ray_mode_equals_camera_mode():
    """Given the rays camera_rays_host makes for pixels 0..R-1 with rid =
    pix, ray mode traces what camera mode traces: tape and colors equal
    bit for bit (the card's check is chip_smoke.py phase 15)."""
    ts = to_port(_scene_cam()[0])
    tc = make_camera(aspect_ratio=1.0, image_width=16, max_depth=6, defocus_angle=2.0,
                     focus_dist=2.0)
    cols, attrs = mrk.scene_sweep_arrays(ts)
    row = camera_scalar_row(tc)
    r = tc.num_pixels
    pix = torch.arange(r)
    key = prng.PRNGKey(5)
    bs, cs = prng.seed_pair(key)
    o, d = mrk.camera_rays_host(row, pix, pix, cs, tc.image_width)
    ray = mk.mega_forward(cols, attrs, o, d, bounce_seed=bs, max_depth=tc.max_depth)
    cam_ = mk.mega_forward_camera(cols, attrs, row, None, bounce_seed=bs, cam_seed=cs,
                                  pix0=0, n_valid=r, w=tc.image_width, max_depth=tc.max_depth)
    assert torch.equal(ray.lengths, cam_.lengths)
    assert torch.equal(_written(ray.tape, ray.lengths).view(torch.int32),
                       _written(cam_.tape, cam_.lengths).view(torch.int32))
    assert torch.equal(ray.colors, cam_.colors)
    tracer = make_tape_tracer(key, tc.max_depth, use_mega=True, mega_bwd=True, device="cpu")
    camera_tracer = make_tape_camera_tracer(tc, bs, cs, iota_pix=True, device="cpu")
    assert torch.equal(tracer(ts, o, d), camera_tracer(ts, pix))


def test_mega_backward_on_jax_tape(case):
    """K7's plain version on JAX's own ray-mode tape (the parameters come
    from the scene, as in JAX) against JAX's mega_backward: g_pm and the
    ray cotangents gathered at the refill positions."""
    c = case
    n, r = c["scene"].num_spheres, c["o"].shape[0]
    print(f"{int(c['grazing'].sum())} of {r} rays have a grazing hit")
    tape, lengths = _to_port_tape(_Packed(c["jout"]), r, c["cam"].max_depth)
    g_pm, g_ray = mbk.mega_backward(c["cols"], c["attrs"], tape, lengths,
                                    torch.from_numpy(c["gc"]), n)
    j_pm, j_ray = c["j_k7"]
    err = (_col_err(g_pm.numpy()[:n], j_pm), _col_err(g_ray.numpy(), j_ray))
    print(f"K7 on JAX's tape: g_pm {err[0].max():.3g}, rays {err[1].max():.3g}")
    assert max(e.max() for e in err) < 1e-4, err


def test_tracer_matches_jax_tracer(case):
    c = case
    colors, g_pm, g_ray = _port_tracer_grads(c, c["gc"])
    d = np.abs(colors - c["j_colors"])
    assert d.max() < 5e-4 and d.mean() < 5e-6
    j_pm, j_ray = c["j_tr"]
    err = (_col_err(g_pm, j_pm), _col_err(g_ray, j_ray))
    print(f"tracer vs JAX: g_pm {err[0].max():.3g}, rays {err[1].max():.3g}")
    assert max(e.max() for e in err) < 1e-4, err


def test_tracer_grads_match_replay_autograd(case):
    """The tracer's backward (K7's plain walk) against autograd of the
    replay oracle through the whole ray, the rays differentiable."""
    c = case
    g = np.random.default_rng(4).normal(size=c["gc"].shape).astype(np.float32)
    _, g_pm, g_ray = _port_tracer_grads(c, g)
    p = {k: getattr(c["ts"], k).clone().requires_grad_() for k in FIELDS}
    o = torch.from_numpy(c["o"]).requires_grad_()
    d = torch.from_numpy(c["d"]).requires_grad_()
    port = c["port"]
    out = replay_from_tape(c["ts"].with_diff_params(p), port.tape, port.lengths, o.shape[0],
                           o, d)
    np.testing.assert_allclose(out.detach().numpy(), port.colors.numpy(), rtol=1e-5, atol=1e-6)
    (out * torch.from_numpy(g)).sum().backward()
    want_pm = _pm({k: v.grad for k, v in p.items()})
    want_ray = torch.cat([o.grad, d.grad], 1).numpy()
    err = (_col_err(g_pm, want_pm), _col_err(g_ray, want_ray))
    print(f"tracer vs replay autograd: g_pm {err[0].max():.3g}, rays {err[1].max():.3g}")
    assert max(e.max() for e in err) < 1e-4, err


def test_k7_equals_k8_on_one_tape(case):
    """On one tape K7 (parameters from the scene) and K8 with ray grads
    (parameters off the tape) are the same walk: their plain versions
    agree bit for bit, and K8's scene cotangents do not depend on whether
    it also returns the ray cotangents."""
    c = case
    port, n = c["port"], c["scene"].num_spheres
    g = torch.from_numpy(c["gc"])
    k7 = mbk.mega_backward_plain(c["cols"], c["attrs"], port.tape, port.lengths, g, n)
    k8 = wbk.mega_walk_backward_plain(port.tape, port.lengths, g, n, ray_grads=True)
    assert torch.equal(k7[0], k8[0]) and torch.equal(k7[1], k8[1])
    assert torch.equal(wbk.mega_walk_backward(port.tape, port.lengths, g, n), k8[0])
    # rays that did not finish carry no cotangent
    fin = torch.zeros(port.lengths.shape[0], dtype=torch.bool)
    for depth in range(port.tape.shape[0]):
        rows = port.tape[depth].contiguous().view(torch.int32)[:, mk.T_FLG]
        fin |= (port.lengths > depth) & ((rows & mk.F_FIN) != 0)
    assert not bool(k7[1][~fin].any())
    assert bool(k7[1][fin].abs().sum(1).gt(0).all())


def test_ray_grads_off_gives_zero_ray_grads(case):
    c = case
    colors, g_pm, g_ray = _port_tracer_grads(c, c["gc"], ray_grads=False)
    colors_on, g_pm_on, _ = _port_tracer_grads(c, c["gc"])
    assert not g_ray.any()
    np.testing.assert_array_equal(colors, colors_on)
    np.testing.assert_array_equal(g_pm, g_pm_on)


def test_tracer_checks_shapes(case):
    c = case
    tr = make_tape_tracer(prng.PRNGKey(1), 2, use_mega=True, mega_bwd=True, device="cpu")
    with pytest.raises(ValueError, match="ray_o and ray_d"):
        tr(c["ts"], torch.zeros(4, 3), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="both ray_o and ray_d"):
        replay_from_tape(c["ts"], c["port"].tape, c["port"].lengths, c["o"].shape[0],
                         ray_o=torch.zeros(c["o"].shape[0], 3))
