"""The port's scene-gradient path (plain versions, CPU) against the JAX
package: the recording forward against mega_forward_camera, the reverse
walk against mega_walk_backward and jax.grad of replay_from_tape on JAX's
own tape, and the tracer end to end against the JAX "unified" tracer.
JAX runs its Pallas kernels in interpret mode.

The end-to-end checks use the five-material scene of tests/test_mega.py
(ground R = 100).  On the RTiOW final scene (ground R = 1000) two correct
implementations can take different paths on a few pixels, so there the
backward is held against JAX on JAX's own tape.

Bands: tape ints equal; tape floats at most 1% of rows over 5e-4 and mean
< 5e-6 (one-ulp camera differences grow with each bounce: measured one
row of 586 at 6.5e-4, mean 2.8e-7), depth-0 rows max 1e-6; the backward
per column, normalized by its largest value, atol 1e-4 (tests/
test_mega_bwd.py:104) on the rays without a grazing hit (_grazing_rays);
tracer colors atol 5e-4 and grads normalized atol 5e-3 (tests/
test_mega.py:241,254) on those rays.  Over all rays the geometric
columns (center, radius, fuzz, ior) get the measured bands below: at a
grazing hit disc = h*h - a*c is the difference of two nearly equal
numbers, so one rounding more or less moves it by up to a few percent
(the JAX kernels run compiled, where XLA fuses h*h - a*c; the port
rounds each product, as jax.vjp op by op does), and the derivative of t
carries 1 / sqrt(disc)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.grad import diff_render as jdr
from distributed_raytracer_tpu.grad import tapegrad as jtg
from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.ops.camera import make_camera as jax_make_camera
from distributed_raytracer_tpu.ops.pallas.mega_bwd_kernel import _local_f_rows
from distributed_raytracer_tpu.ops.pallas.mega_kernel import mega_forward_camera as jax_forward
from distributed_raytracer_tpu.ops.pallas.mega_render_kernel import camera_scalar_row
from distributed_raytracer_tpu.ops.pallas.mega_walk_bwd_kernel import mega_walk_backward
from distributed_raytracer_tpu_torch import image_loss, make_tape_camera_tracer
from distributed_raytracer_tpu_torch.grad.tapegrad import replay_from_tape
from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_bwd_kernel import (
    mega_walk_backward_plain,
)
from test_mega import setup as mega_setup
from test_torch_scene import to_port

torch.set_num_threads(1)
FIELDS = ("centers", "radii", "albedo", "fuzz", "ior")
FIELD_COLS = {"centers": [0, 1, 2], "radii": [3], "albedo": [4, 5, 6], "fuzz": [7], "ior": [8]}
GRAZING = 1e-3  # a hit row with disc < GRAZING * h^2 is grazing
INT_COLS = (mk.T_IDX, mk.T_RAY, mk.T_FLG)


def _seeds(key):
    """The JAX tracer's two int32 seeds from its key (tapegrad.py:918-921)."""
    seed = jax.random.randint(key, (), 0, 2**31 - 1, dtype=jnp.int32)
    cam_seed = jax.random.randint(jax.random.fold_in(key, 0xCA3), (), 0, 2**31 - 1,
                                  dtype=jnp.int32)
    return int(seed), int(cam_seed)


def _small_case():
    """The tests/test_mega.py scene and defocus camera, 16x16, depth 6."""
    scene = mega_setup()[0]
    camera = jax_make_camera(aspect_ratio=1.0, image_width=16, max_depth=6, vfov=30.0,
                             lookfrom=(0.0, 0.5, 2.0), lookat=(0.0, 0.0, -1.5),
                             vup=(0.0, 1.0, 0.0), defocus_angle=1.0, focus_dist=3.0)
    return scene, camera


def _jax_tape(scene, camera, bs, cs):
    """JAX's recording forward (unified variant's layout), interpret mode."""
    ids = jnp.arange(camera.num_pixels, dtype=jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        out = jax_forward(scene, ids, jnp.int32(bs), jnp.int32(cs), camera_scalar_row(camera),
                          camera.image_width, camera.max_depth, pool=128, block_rays=128,
                          iota_pix=True, record_params=True, pack_ti=True)
        jax.block_until_ready(out.tape_f)
    return out


def _to_port_tape(out, n_rays, max_depth):
    """JAX's pool-row tape [T, 32, B] as the port's [max_depth, R, 32] tape:
    each active lane's row goes to (its ray, the count of that ray's
    earlier rows)."""
    tf = np.asarray(out.tape_f)[: int(out.n_it)].transpose(0, 2, 1).reshape(-1, 32)
    bits = tf.view(np.int32)
    rows = tf[(bits[:, mk.T_FLG] & mk.F_ACT) != 0]   # row order is pool-row order
    ray = rows.view(np.int32)[:, mk.T_RAY]
    order = np.argsort(ray, kind="stable")
    ray_sorted = ray[order]
    first = np.searchsorted(ray_sorted, ray_sorted)
    depth = np.empty_like(ray)
    depth[order] = np.arange(len(ray)) - first
    tape = np.zeros((max_depth, n_rays, 32), np.float32)
    tape[depth, ray] = rows
    lengths = np.bincount(ray, minlength=n_rays).astype(np.int32)
    return torch.from_numpy(tape), torch.from_numpy(lengths)


def _port_forward(scene, camera, bs, cs):
    ts, tc = to_port(scene, camera)
    cols, attrs, cam_row = mrk.prepare(ts, tc, "cpu")
    return mk.mega_forward_camera(cols, attrs, cam_row, None, bounce_seed=bs, cam_seed=cs,
                                  pix0=0, n_valid=tc.num_pixels, w=tc.image_width,
                                  max_depth=tc.max_depth), ts, tc


def _written(tape, lengths):
    depth = torch.arange(tape.shape[0])[:, None]
    return tape[depth < lengths[None, :].long()]


def _pm(g):
    """A scene gradient (dict or JAX Scene) as [n, 9] numpy."""
    get = (lambda k: g[k]) if isinstance(g, dict) else (lambda k: getattr(g, k))
    cols = [np.asarray(get(k)).reshape(np.asarray(get(k)).shape[0], -1) for k in FIELDS]
    return np.concatenate(cols, axis=1)


# columns of g_pm: albedo, which moves no path, and the geometric ones
# (center, radius, fuzz, ior), which move hit points and directions, so a
# near-grazing hit or a near-critical refraction contributes a
# near-singular term
SMOOTH = [4, 5, 6]
GEOMETRIC = [0, 1, 2, 3, 7, 8]


def _col_err(got, want):
    """Per-column max |got - want|, normalized by the column's max |want|."""
    return np.abs(got - want).max(axis=0) / (np.abs(want).max(axis=0) + 1e-8)


def _assert_cols_close(got, want, atol_smooth, atol_geometric, what):
    err = _col_err(got, want)
    assert err[SMOOTH].max() < atol_smooth, (what, err)
    assert err[GEOMETRIC].max() < atol_geometric, (what, err)


def _field_err(got, want):
    """Per-field max |got - want| over the field's max |want|, the
    normalization of tests/test_mega.py:250-254."""
    return {k: np.abs(got[:, c] - want[:, c]).max() / (np.abs(want[:, c]).max() + 1e-8)
            for k, c in FIELD_COLS.items()}


def _grazing_rays(tape, lengths):
    """[R] bool: the rays with a grazing hit, some hit row whose
    discriminant disc = h*h - a*c is below GRAZING * h*h (computed in
    float64 from the recorded row).  Every hit on a sphere of radius r seen
    from distance D has disc / h*h <= (r / D)^2, so on the final scene the
    small spheres seen from afar count too."""
    t = tape.double()
    o, d, c, rw = t[..., mk.T_O:mk.T_O + 3], t[..., mk.T_D:mk.T_D + 3], \
        t[..., mk.T_CW:mk.T_CW + 3], t[..., mk.T_RW]
    oc = c - o
    h = (d * oc).sum(-1)
    disc = h * h - (d * d).sum(-1) * ((oc * oc).sum(-1) - rw * rw)
    flags = tape[..., mk.T_FLG].contiguous().view(torch.int32)
    rows = torch.arange(tape.shape[0])[:, None] < lengths[None, :].long()
    hit = rows & ((flags & mk.F_HIT) != 0)
    return (hit & (disc < GRAZING * h * h)).any(0).numpy()


def _masked(g, grazing):
    """g_color with the grazing rays' cotangents set to zero: the gradient
    is linear in g_color, so this drops those rays' terms."""
    return np.where(grazing[:, None], 0.0, g).astype(np.float32)


@pytest.fixture(scope="module")
def small():
    scene, camera = _small_case()
    bs, cs = _seeds(jax.random.PRNGKey(13))
    jout = _jax_tape(scene, camera, bs, cs)
    port, ts, tc = _port_forward(scene, camera, bs, cs)
    return scene, camera, bs, cs, jout, port, ts, tc


def test_recording_forward_matches_jax(small):
    scene, camera, bs, cs, jout, port, ts, tc = small
    tape, lengths = _to_port_tape(jout, camera.num_pixels, camera.max_depth)
    assert torch.equal(port.lengths, lengths)
    got, want = _written(port.tape, port.lengths), _written(tape, lengths)
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    for c in INT_COLS:
        assert torch.equal(gi[:, c], wi[:, c]), c
    d = (got - want).abs()[:, :mk.T_FLG + 1]
    d[:, list(INT_COLS)] = 0.0
    d[(wi[:, mk.T_FLG] & mk.F_HIT) == 0, mk.T_CW:] = 0.0  # params on hit rows only
    # one-ulp camera differences grow with each bounce: the render's depth-8
    # band (tests/test_mega_render.py:78-108) on rows, not one max
    row_max = d.max(dim=1).values
    assert float((row_max > 5e-4).float().mean()) <= 0.01, float(row_max.max())
    assert float(d.mean()) < 5e-6, float(d.mean())
    n0 = int((lengths > 0).sum())  # the depth-0 rows come first
    assert float(d[:n0].max()) < 1e-6, float(d[:n0].max())
    j_colors = torch.from_numpy(np.array(jout.colors).reshape(-1, 3)[: camera.num_pixels])
    assert float((port.colors - j_colors).abs().max()) < 5e-4


def test_recording_colors_equal_render_kernel(small):
    """At equal seeds the recording forward's colors are sample 0 of the
    port's render, bit for bit (tests/test_mega.py:89-131 in the port)."""
    scene, camera, bs, cs, jout, port, ts, tc = small
    ref = mrk.mega_render_colors(ts, tc, 0, bs, cs, device="cpu")
    assert torch.equal(port.colors, ref)


def test_replay_oracle_reproduces_colors(small):
    scene, camera, bs, cs, jout, port, ts, tc = small
    got = replay_from_tape(ts, port.tape, port.lengths, tc.num_pixels)
    np.testing.assert_allclose(got.numpy(), port.colors.numpy(), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def final_tape():
    """JAX's tape on the final scene at 32x18, depth 8, and its gradients:
    the walk kernel's and jax.grad of the replay oracle's."""
    scene = jp.rtiow_final_scene(seed=0, pad_to=512)
    camera = jp.final_scene_camera(32).replace(max_depth=8)
    bs, cs = _seeds(jax.random.PRNGKey(5))
    out = _jax_tape(scene, camera, bs, cs)
    r = camera.num_pixels
    g = np.random.default_rng(3).normal(size=(r, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        g_walk, _ = mega_walk_backward(out.tape_f, None, out.n_it, jnp.asarray(g),
                                       n_slots=scene.num_spheres, packed_ti=True)
        g_walk = np.asarray(g_walk)
    tf = out.tape_f[: int(out.n_it)]
    jtape = jtg._Tape(fdata=tf[:, :16, :].transpose(0, 2, 1),
                      idata=jax.lax.bitcast_convert_type(tf[:, 26:29, :], jnp.int32)
                      .transpose(0, 2, 1))
    dummy = jnp.zeros((r, 3), jnp.float32)

    def loss(p):
        s = scene.replace(**p)
        return jnp.sum(jtg.replay_from_tape(s, dummy, dummy, jtape, int(out.n_it),
                                            rays_from_tape=True) * g)

    g_replay = jax.grad(loss)({k: getattr(scene, k) for k in FIELDS})
    tape, lengths = _to_port_tape(out, r, camera.max_depth)
    grazing = _grazing_rays(tape, lengths)
    with pltpu.force_tpu_interpret_mode():
        g_calm, _ = mega_walk_backward(out.tape_f, None, out.n_it,
                                       jnp.asarray(_masked(g, grazing)),
                                       n_slots=scene.num_spheres, packed_ti=True)
        g_calm = np.asarray(g_calm)
    return scene, camera, out, g, g_walk, _pm(g_replay), grazing, g_calm


def test_walk_backward_on_jax_tape(final_tape):
    scene, camera, out, g, g_walk, g_replay, grazing, g_calm = final_tape
    n = scene.num_spheres
    tape, lengths = _to_port_tape(out, camera.num_pixels, camera.max_depth)
    # the rays without a grazing hit (352 of 576): every column at 1e-4
    # (measured 2.8e-5)
    assert 0.2 < grazing.mean() < 0.5, grazing.mean()
    calm = mega_walk_backward_plain(tape, lengths, torch.from_numpy(_masked(g, grazing)),
                                    n).numpy()[:n]
    assert _col_err(calm, g_calm[:n]).max() < 1e-4, _col_err(calm, g_calm[:n])
    # all rays: the grazing rows' rounding (module docstring) reaches 8.4e-3
    # of a geometric column (ior of sphere 484), albedo 5.5e-7
    got = mega_walk_backward_plain(tape, lengths, torch.from_numpy(g), n).numpy()[:n]
    _assert_cols_close(got, g_walk[:n], 1e-4, 1e-2, "vs JAX walk kernel")
    # the replay re-derives each row's state from the ray's first row, the
    # walk reads it off the tape: at grazing rows the two differ, JAX's own
    # walk kernel and replay by up to 2.0e-2 (geometric) and 1.9e-4 (albedo)
    _assert_cols_close(got, g_replay, 5e-4, 3e-2, "vs jax.grad of the replay")


def _jax_walk(out, g, n, jit):
    """JAX's walk (mega_walk_bwd_kernel.py:59) over its own pool-row tape in
    plain JAX: per row, jax.vjp of _local_f_rows with the lanes' carries,
    cut at take, the parameter cotangents summed into the winner's bin
    (float64 sums); the per-row VJP jitted or run op by op."""
    def row_vjp(args, rest, cot):
        _, vjp = jax.vjp(lambda *z: _local_f_rows(*z, *rest), *args)
        return vjp(tuple(cot))

    fn = jax.jit(row_vjp) if jit else row_vjp
    tf = np.asarray(out.tape_f)[: int(out.n_it)]
    carry = np.zeros((9, tf.shape[2]), np.float32)
    acc = np.zeros((n + 1, 9))
    for row in tf[::-1]:
        bits = row.view(np.int32)
        flags, ray = bits[mk.T_FLG], np.clip(bits[mk.T_RAY], 0, g.shape[0] - 1)
        hit, fin = (flags & mk.F_HIT) != 0, (flags & mk.F_FIN) != 0
        args = [jnp.asarray(row[k]) for k in range(9)] + [
            jnp.asarray(row[mk.T_CW + k]) for k in range(9)]
        args[12] = jnp.where(hit, args[12], 1.0)  # the kernel's guards
        args[17] = jnp.where(hit, args[17], 1.0)
        rest = [jnp.asarray(row[mk.T_MT]), *(jnp.asarray(row[mk.T_RU + k]) for k in range(4)),
                jnp.asarray(hit), jnp.asarray((flags & mk.F_ACT) != 0)]
        g_row = np.where(fin[:, None], g[ray], 0.0).T.astype(np.float32)
        cots = fn(args, rest, [jnp.asarray(v) for v in (*carry, *g_row)])
        np.add.at(acc, np.where(hit, bits[mk.T_IDX], n),
                  np.stack([np.asarray(c) for c in cots[9:18]], 1))
        carry = np.where((flags & mk.F_TAKE) != 0, 0.0,
                         np.stack([np.asarray(c) for c in cots[:9]])).astype(np.float32)
    return acc[:n]


def test_walk_gap_is_xla_compilation(final_tape):
    """Where the port's walk and JAX's walk kernel part (8.4e-3 of a
    geometric column, test_walk_backward_on_jax_tape): JAX's own walk with
    its per-row VJP run op by op is the port's walk (measured 4.7e-5 to
    1.55e-4 by host, see below), and
    with the per-row VJP jitted it is JAX's kernel (measured 1.6e-7).  The
    compiled and the op-by-op evaluation of _local_f_rows round the
    grazing rows' disc differently."""
    scene, camera, out, g, g_walk, g_replay, grazing, g_calm = final_tape
    n = scene.num_spheres
    tape, lengths = _to_port_tape(out, camera.num_pixels, camera.max_depth)
    port = mega_walk_backward_plain(tape, lengths, torch.from_numpy(g), n).numpy()[:n]
    op_by_op = _jax_walk(out, g, n, jit=False)
    # Both against the same walk in float64, per element of g_pm normalized
    # by its column's max: the 1e-4 band between the two holds on every
    # element except those that op-by-op JAX itself puts more than 1e-4
    # from float64 (21 elements on an AVX-512 host, among them the ior of
    # sphere 484, where JAX's rounding depends on the host's XLA:CPU code:
    # port and JAX part by 1.55e-4 there, 7.8e-3 and 8.0e-3 from float64);
    # the port is held to float64 at the bands of
    # test_walk_backward_on_jax_tape (measured 5.6e-7 albedo, 7.8e-3 ior)
    exact = mega_walk_backward_plain(tape, lengths, torch.from_numpy(g), n,
                                     dtype=torch.float64).numpy()[:n]
    scale = np.abs(exact).max(axis=0) + 1e-8
    d_port, d_jax = np.abs(port - exact) / scale, np.abs(op_by_op - exact) / scale
    d_pj = np.abs(port - op_by_op) / (np.abs(op_by_op).max(axis=0) + 1e-8)
    excused = d_jax > 1e-4
    print(f"per column, port-f64 {d_port.max(0)}, jax-f64 {d_jax.max(0)}, port-jax "
          f"{d_pj.max(0)}; {int(excused.sum())} excused")
    _assert_cols_close(port, exact, 1e-4, 1e-2, "port vs the float64 walk")
    assert d_pj[~excused].max() < 1e-4, np.where(excused, 0.0, d_pj).max(0)
    compiled = _jax_walk(out, g, n, jit=True)
    assert _col_err(compiled, g_walk[:n]).max() < 1e-6, _col_err(compiled, g_walk[:n])


def test_walk_backward_float64_referee(final_tape):
    """The plain walk in float64 on the same f32 tape is the referee of the
    f32 walks: on the rays without a grazing hit the port's f32 walk and
    JAX's walk kernel both lie within 5e-4 of it per normalized column
    (measured 1.17e-4 and 1.21e-4, fuzz)."""
    scene, camera, out, g, g_walk, g_replay, grazing, g_calm = final_tape
    n = scene.num_spheres
    tape, lengths = _to_port_tape(out, camera.num_pixels, camera.max_depth)
    gm = torch.from_numpy(_masked(g, grazing))
    exact = mega_walk_backward_plain(tape, lengths, gm, n, dtype=torch.float64)
    assert exact.dtype == torch.float64
    exact = exact.numpy()[:n]
    f32 = mega_walk_backward_plain(tape, lengths, gm, n).numpy()[:n]
    assert _col_err(f32, exact).max() < 5e-4, _col_err(f32, exact)
    assert _col_err(g_calm[:n], exact).max() < 5e-4, _col_err(g_calm[:n], exact)


@pytest.fixture(scope="module")
def tracers(small):
    scene, camera, bs, cs, jout, port, ts, tc = small
    key = jax.random.PRNGKey(13)
    r = camera.num_pixels
    gc = np.random.default_rng(3).normal(size=(r, 3)).astype(np.float32)
    ids = jnp.arange(r, dtype=jnp.int32)
    jtr = jtg.make_tape_camera_tracer(key, camera, pool=128, block_rays=128, iota_pix=True,
                                      variant="unified")
    grazing = _grazing_rays(port.tape, port.lengths)
    params = {k: getattr(scene, k) for k in FIELDS}
    with pltpu.force_tpu_interpret_mode():
        val, g = jax.value_and_grad(lambda p: jnp.sum(jtr(scene.replace(**p), ids) * gc))(params)
        g_calm = jax.grad(
            lambda p: jnp.sum(jtr(scene.replace(**p), ids) * _masked(gc, grazing)))(params)
        colors = np.asarray(jtr(scene, ids))
    return colors, float(val), _pm(g), gc, grazing, _pm(g_calm)


def _port_grads(ts, tc, bs, cs, gc, **kw):
    tr = make_tape_camera_tracer(tc, bs, cs, iota_pix=True, device="cpu")
    p = {k: getattr(ts, k).clone().requires_grad_() for k in FIELDS}
    colors = tr(ts.with_diff_params(p), torch.arange(tc.num_pixels), **kw)
    (colors * torch.from_numpy(gc)).sum().backward()
    return colors.detach(), _pm({k: v.grad for k, v in p.items()})


def test_tracer_matches_jax_tracer(small, tracers):
    scene, camera, bs, cs, jout, port, ts, tc = small
    j_colors, j_val, j_g, gc, grazing, j_calm = tracers
    colors, g = _port_grads(ts, tc, bs, cs, gc)
    np.testing.assert_allclose(colors.numpy(), j_colors, atol=5e-4)
    # the rays without a grazing hit (247 of 256): grads per column at 5e-3
    assert grazing.sum() < 0.1 * grazing.size, grazing.sum()
    _, calm = _port_grads(ts, tc, bs, cs, _masked(gc, grazing))
    assert _col_err(calm, j_calm).max() < 5e-3, _col_err(calm, j_calm)
    # all rays: the two tapes differ by up to 6.5e-4 on deep rows (one-ulp
    # camera differences grown by the bounces), and the 9 grazing rays turn
    # that into 3.0e-2 of a geometric field under test_mega.py's per-field
    # normalization (centers 3.0e-2, radii 2.8e-2, fuzz 2.2e-2; albedo
    # 2.7e-6, ior 5.9e-6); the port's walk on JAX's own tape is 1.4e-4 from
    # JAX's grads
    err = _field_err(g, j_g)
    assert max(err["albedo"], err["ior"]) < 5e-3, err
    assert max(err.values()) < 5e-2, err


def test_tracer_grads_match_replay_autograd(small):
    """The tracer's backward (the plain reverse walk) against autograd of
    the replay oracle through the whole ray, on the small scene."""
    scene, camera, bs, cs, jout, port, ts, tc = small
    gc = np.random.default_rng(4).normal(size=(tc.num_pixels, 3)).astype(np.float32)
    _, g = _port_grads(ts, tc, bs, cs, gc)
    p = {k: getattr(ts, k).clone().requires_grad_() for k in FIELDS}
    out = replay_from_tape(ts.with_diff_params(p), port.tape, port.lengths, tc.num_pixels)
    (out * torch.from_numpy(gc)).sum().backward()
    _assert_cols_close(g, _pm({k: v.grad for k, v in p.items()}), 1e-4, 1e-3,
                       "vs replay autograd")


def test_albedo_grad_matches_finite_difference(small):
    """d loss / d albedo by central differences (eps 1e-2; albedo moves no
    path, so the loss is smooth in it) against the tracer's backward."""
    scene, camera, bs, cs, jout, port, ts, tc = small
    tr = make_tape_camera_tracer(tc, bs, cs, iota_pix=True, device="cpu")
    ids = torch.arange(tc.num_pixels)
    target = torch.full((tc.num_pixels, 3), 0.25)
    albedo = ts.albedo.clone().requires_grad_()
    image_loss(tr(ts.with_diff_params({"albedo": albedo}), ids), target).backward()
    eps = 1e-2
    for sphere in (0, 1, 2):  # lambertian ground, lambertian, metal: all hit
        for ch in range(3):
            up, dn = ts.albedo.clone(), ts.albedo.clone()
            up[sphere, ch] += eps
            dn[sphere, ch] -= eps
            with torch.no_grad():
                lu = image_loss(tr(ts.with_diff_params({"albedo": up}), ids), target)
                ld = image_loss(tr(ts.with_diff_params({"albedo": dn}), ids), target)
            fd = float(lu - ld) / (2 * eps)
            np.testing.assert_allclose(float(albedo.grad[sphere, ch]), fd, rtol=1e-2,
                                       err_msg=f"sphere {sphere} channel {ch}")


def test_pixel_shards_concatenate(small):
    """Two pix0 halves give the whole image's colors bit for bit, and
    their gradients sum to the whole image's."""
    scene, camera, bs, cs, jout, port, ts, tc = small
    r = tc.num_pixels
    gc = torch.from_numpy(np.random.default_rng(5).normal(size=(r, 3)).astype(np.float32))
    tr = make_tape_camera_tracer(tc, bs, cs, iota_pix=True, device="cpu")

    def run(ids, pix0, g):
        p = {k: getattr(ts, k).clone().requires_grad_() for k in FIELDS}
        colors = tr(ts.with_diff_params(p), ids, pix0)
        (colors * g).sum().backward()
        return colors.detach(), _pm({k: v.grad for k, v in p.items()})

    whole_c, whole_g = run(torch.arange(r), None, gc)
    h = r // 2
    a_c, a_g = run(torch.arange(h), 0, gc[:h])
    b_c, b_g = run(torch.arange(r - h), h, gc[h:])
    assert torch.equal(torch.cat([a_c, b_c]), whole_c)
    # the same terms summed in another grouping: normalized per column
    assert _col_err(a_g + b_g, whole_g).max() < 1e-6


def test_pix0_needs_iota_pix(small):
    scene, camera, bs, cs, jout, port, ts, tc = small
    tr = make_tape_camera_tracer(tc, bs, cs, device="cpu")
    with pytest.raises(ValueError, match="iota_pix"):
        tr(ts, torch.arange(4), 2)


def test_tape_header_matches_python():
    """csrc/tape.cuh names the tape's columns and flags for the kernels
    with the values ops/kernels/mega_kernel.py gives them."""
    header = (mk.__file__.rsplit("/ops/", 1)[0] + "/csrc/tape.cuh")
    with open(header) as f:
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", f.read()))
    want = {k: getattr(mk, k) for k in dir(mk) if re.fullmatch(r"(T|F)_[A-Z]+|TAPE_COLS", k)}
    assert len(want) == 20
    assert {k: int(v) for k, v in consts.items()} == want


def test_image_loss_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(64, 3)).astype(np.float32)
    target = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    want = float(jdr.image_loss(jnp.asarray(img), jnp.asarray(target)))
    got = float(image_loss(torch.from_numpy(img), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
