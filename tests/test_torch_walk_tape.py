"""The port's walk tape tracer (plain versions, CPU) against the JAX
package: the recording walk against mega_walk_forward_camera, the reverse
walk over the pack's slots against mega_walk_backward on JAX's own walk
tape, and make_tape_camera_walk_tracer end to end against JAX's, at
tests/test_mega_walk_tape.py:72-95's shape (640 spheres in 3 chunks of
256, 24x24, depth 4).  JAX runs its Pallas kernels in interpret mode, once
per module.

Bands (PR 2's, tests/test_torch_tapegrad.py): tape ints equal; tape
floats at most 1% of rows over 5e-4, mean < 5e-6, depth-0 rows 1e-6;
colors 5e-4 against JAX's host oracle (tests/test_mega_render.py::
_oracle_sample; measured 5.1e-7), and against JAX's interpret kernel on
every pixel where that kernel agrees with its own oracle (it parts from
it at one pixel, by 1.3e-3); the tracer's gradients on the rays without a
grazing hit 5e-3 per column normalized; over all rays the geometric
columns keep measured bands (a grazing hit's disc = h*h - a*c cancels,
ROADMAP Queue 3).  The reverse walk on JAX's own tape misses PR 2's 1e-4
on the rays without a grazing hit (1.15e-4, center y): the same walk in
float64 referees it, and the port's f32 walk (1.13e-4, ior) and JAX's
(4.4e-5) both lie within 2e-4 of it, so the two f32 walks are held to
2e-4 of each other."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.grad import tapegrad as jtg
from distributed_raytracer_tpu.ops.camera import make_camera as jax_make_camera
from distributed_raytracer_tpu.ops.pallas import mega_walk_kernel as jmwk
from distributed_raytracer_tpu.ops.pallas.mega_render_kernel import camera_scalar_row
from distributed_raytracer_tpu.ops.pallas.mega_walk_bwd_kernel import mega_walk_backward
from distributed_raytracer_tpu_torch import make_tape_camera_walk_tracer
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row as port_camera_row
from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_bwd_kernel import (
    mega_walk_backward_plain,
)
from test_mega_render import _oracle_sample
from test_mega_walk_tape import _field_scene
from test_torch_scene import to_port
from test_torch_tapegrad import (
    FIELDS,
    INT_COLS,
    _col_err,
    _grazing_rays,
    _masked,
    _pm,
    _seeds,
    _to_port_tape,
    _written,
)

torch.set_num_threads(1)
CHUNK = 256


@pytest.fixture(scope="module")
def run():
    """JAX's recording walk, walk backward and tracer gradients, and the
    port's pack and recording walk, on the same scene, camera and seeds."""
    scene = _field_scene()
    camera = jax_make_camera(aspect_ratio=1.0, image_width=24, samples_per_pixel=1,
                             max_depth=4)
    pack = jmwk.walk_pack_for(scene, camera, chunk=CHUNK)
    key = jax.random.PRNGKey(7)
    bs, cs = _seeds(key)
    r = camera.num_pixels
    n_slots = pack.slot_to_orig.shape[0]
    with pltpu.force_tpu_interpret_mode():
        sp, at, _ = jmwk.walk_pack_arrays_from_scene(scene, pack.slot_to_orig, pack.chunk)
        out = jmwk.mega_walk_forward_camera(
            sp, at, pack.bounds, camera_scalar_row(camera), jnp.int32(0), jnp.int32(bs),
            jnp.int32(cs), n_pix=r, w=camera.image_width, max_depth=camera.max_depth,
            chunk=pack.chunk, n_chunks=pack.n_chunks, pool=128, block_rays=128)
        jax.block_until_ready(out.tape_f)
    assert int(out.clean) == 1
    # JAX's walk tape keeps idx, ray and flags in tape_i rows 0-2; the
    # port's row holds them as int bits in columns 26-28
    tf = np.array(out.tape_f)
    tf[:, mk.T_IDX:mk.T_FLG + 1, :] = np.asarray(out.tape_i)[:, 0:3, :].view(np.float32)
    tape, lengths = _to_port_tape(types.SimpleNamespace(tape_f=tf, n_it=out.n_it), r,
                                  camera.max_depth)

    ts, tc = to_port(scene, camera)
    port_pack = mwk.walk_pack_for(ts, tc, chunk=CHUNK)
    port = mwk.mega_walk_forward_camera(
        port_pack.scene_pack, port_pack.attrs, port_pack.bounds, port_pack.chunk_len,
        port_camera_row(tc), bounce_seed=bs, cam_seed=cs, pix0=0, n_valid=r,
        w=tc.image_width, max_depth=tc.max_depth)
    grazing = _grazing_rays(port.tape, port.lengths)
    gc = np.random.default_rng(3).normal(size=(r, 3)).astype(np.float32)

    ids = jnp.zeros((r,), jnp.int32)
    jtr = jtg.make_tape_camera_walk_tracer(key, camera, scene, chunk=CHUNK, pool=128,
                                           block_rays=128)
    params = {k: getattr(scene, k) for k in FIELDS}
    with pltpu.force_tpu_interpret_mode():
        g_walk = np.asarray(mega_walk_backward(out.tape_f, out.tape_i, out.n_it,
                                               jnp.asarray(gc), n_slots=n_slots,
                                               ray_grads=False)[0])
        g_walk_calm = np.asarray(mega_walk_backward(
            out.tape_f, out.tape_i, out.n_it, jnp.asarray(_masked(gc, grazing)),
            n_slots=n_slots, ray_grads=False)[0])
        j_colors = np.asarray(jtr(scene, ids))
        j_g = jax.grad(lambda p: jnp.sum(jtr(scene.replace(**p), ids) * gc))(params)
        j_calm = jax.grad(
            lambda p: jnp.sum(jtr(scene.replace(**p), ids) * _masked(gc, grazing)))(params)
    # the walk tracer's rays are sample 0 (rid = the pixel)
    oracle = np.asarray(_oracle_sample(scene, camera, jnp.int32(0), jnp.int32(bs),
                                       jnp.int32(cs)))
    return types.SimpleNamespace(
        camera=camera, bs=bs, cs=cs, jout=out, tape=tape, lengths=lengths, ts=ts, tc=tc,
        pack=port_pack, port=port, grazing=grazing, gc=gc, g_walk=g_walk,
        g_walk_calm=g_walk_calm, j_colors=j_colors, j_g=_pm(j_g), j_calm=_pm(j_calm),
        oracle=oracle)


def test_recording_walk_matches_jax(run):
    assert run.pack.n_chunks == 3
    assert torch.equal(run.port.lengths, run.lengths)
    got, want = _written(run.port.tape, run.port.lengths), _written(run.tape, run.lengths)
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    for c in INT_COLS:  # the winner's slot, the ray, the flags
        assert torch.equal(gi[:, c], wi[:, c]), c
    d = (got - want).abs()[:, :mk.T_FLG + 1]
    d[:, list(INT_COLS)] = 0.0
    # parameters on hit rows only (JAX's miss rows hold its defaults r = 1,
    # ior = 1, mat = ABSORB; the port's zeros: no output depends on them)
    d[(wi[:, mk.T_FLG] & mk.F_HIT) == 0, mk.T_CW:] = 0.0
    row_max = d.max(dim=1).values
    assert float((row_max > 5e-4).float().mean()) <= 0.01, float(row_max.max())
    assert float(d.mean()) < 5e-6, float(d.mean())
    n0 = int((run.lengths > 0).sum())
    assert float(d[:n0].max()) < 1e-6, float(d[:n0].max())
    _assert_colors(run, run.port.colors.numpy(),
                   np.asarray(run.jout.colors).reshape(-1, 3)[:run.tc.num_pixels])


def _assert_colors(run, got, jax_kernel):
    """got against JAX's host oracle at 5e-4, and against JAX's interpret
    kernel wherever that kernel agrees with its oracle."""
    assert np.abs(got - run.oracle).max() < 5e-4, np.abs(got - run.oracle).max()
    off = np.abs(got - jax_kernel).max(axis=1) > 5e-4
    jax_off = np.abs(jax_kernel - run.oracle).max(axis=1) > 5e-4
    assert not (off & ~jax_off).any(), np.nonzero(off & ~jax_off)
    assert jax_off.sum() <= 2, jax_off.sum()


def test_walk_backward_on_jax_walk_tape(run):
    """The plain reverse walk over the 768 slots on JAX's own walk tape
    against JAX's walk backward, both refereed by the same walk in
    float64."""
    n = run.pack.n_slots
    gm = torch.from_numpy(_masked(run.gc, run.grazing))
    calm = mega_walk_backward_plain(run.tape, run.lengths, gm, n).numpy()[:n]
    exact = mega_walk_backward_plain(run.tape, run.lengths, gm, n,
                                     dtype=torch.float64).numpy()[:n]
    assert _col_err(calm, exact).max() < 2e-4, _col_err(calm, exact)
    assert _col_err(run.g_walk_calm[:n], exact).max() < 2e-4, _col_err(run.g_walk_calm[:n],
                                                                         exact)
    err = _col_err(calm, run.g_walk_calm[:n])
    assert err.max() < 2e-4, err
    assert err[4:7].max() < 1e-6, err  # albedo moves no path: measured 1.5e-7
    got = mega_walk_backward_plain(run.tape, run.lengths, torch.from_numpy(run.gc), n)
    err = _col_err(got.numpy()[:n], run.g_walk[:n])
    assert err[4:7].max() < 1e-4, err
    assert err.max() < 1e-2, err


def _port_grads(run, gc, scene=None, **kw):
    scene = run.ts if scene is None else scene
    tr = make_tape_camera_walk_tracer(run.tc, run.bs, run.cs, scene, chunk=CHUNK,
                                      device="cpu", **kw)
    p = {k: getattr(scene, k).clone().requires_grad_() for k in FIELDS}
    colors = tr(scene.with_diff_params(p), torch.arange(run.tc.num_pixels))
    (colors * torch.from_numpy(gc)).sum().backward()
    return colors.detach(), _pm({k: v.grad for k, v in p.items()})


def test_tracer_colors_equal_walk_render(run):
    colors, _ = _port_grads(run, run.gc)
    ren = mwk.mega_walk_colors(run.pack, run.tc, 0, run.bs, run.cs, device="cpu")
    assert torch.equal(colors, ren)
    assert torch.equal(colors, run.port.colors)
    _assert_colors(run, colors.numpy(), run.j_colors)


def test_tracer_grads_match_jax_tracer(run):
    """Gradients in the original sphere order against JAX's tracer."""
    assert 0 < run.grazing.sum() < 0.25 * run.grazing.size, run.grazing.sum()
    _, calm = _port_grads(run, _masked(run.gc, run.grazing))
    assert _col_err(calm, run.j_calm).max() < 5e-3, _col_err(calm, run.j_calm)
    _, g = _port_grads(run, run.gc)
    err = _col_err(g, run.j_g)
    assert err[4:7].max() < 5e-3, err
    assert err.max() < 5e-2, err


def test_tracer_absent_spheres_get_zero(run):
    """Spheres of radius 0 in scene0 are left out of the pack: their
    gradients are exact zeros (not the no-hit bin's), and the others' are
    the unpadded scene's, bit for bit."""
    ts = run.ts
    pad = 5
    padded = Scene(**{k: torch.cat([getattr(ts, k), torch.zeros((pad,) + getattr(ts, k).shape[1:],
                                                               dtype=getattr(ts, k).dtype)])
                      for k in ("centers", "radii", "albedo", "mat_type", "fuzz", "ior")})
    colors, g = _port_grads(run, run.gc, scene=padded)
    want_colors, want = _port_grads(run, run.gc)
    assert torch.equal(colors, want_colors)
    assert np.array_equal(g[-pad:], np.zeros((pad, 9), np.float32))
    assert np.array_equal(g[:-pad], want)
    assert np.abs(want).max() > 0.0


def test_tracer_pixel_ids_and_shards(run):
    tc, r = run.tc, run.tc.num_pixels
    tr = make_tape_camera_walk_tracer(tc, run.bs, run.cs, run.ts, chunk=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="pixel_ids"):
        tr(run.ts, torch.arange(r).flip(0))
    with pytest.raises(ValueError, match="pixel_ids"):
        tr(run.ts, torch.arange(r // 2), r // 2)  # ids of the first half, pix0 of the second
    whole = tr(run.ts, torch.arange(r))
    h = r // 2
    halves = torch.cat([tr(run.ts, torch.arange(h)), tr(run.ts, torch.arange(h, r), h)])
    assert torch.equal(halves, whole)
    # wider bounds cull less and change no pixel
    slack = make_tape_camera_walk_tracer(tc, run.bs, run.cs, run.ts, chunk=CHUNK,
                                         bound_slack=0.5, device="cpu")
    assert torch.equal(slack(run.ts, torch.arange(r)), whole)
