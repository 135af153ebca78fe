"""The port's host-loop tape tracer (grad/tapegrad.py: _forward_tape,
_backward_tape, make_tape_tracer(use_mega=False)) on the CPU against the
JAX package's, on tests/test_tapegrad.py's scene (24x24, depth 8, rays of
generate_rays with PRNGKey(7), key PRNGKey(3), g_color a normal draw of
PRNGKey(11)); the rays go to both sides as numpy.  JAX runs once per
module, in module fixtures (K11 and K10 in interpret mode).

Bands: the forward's control flow (n_it, pos, the int columns of the
tape) equal; its colors at the North-star depth-8 band (max 5e-4, mean
5e-6); the tape's draws at ROADMAP's "Threefry draws" band (u bit for
bit, the unit vector 1e-6) and its o, d, atten and contrib columns at
2e-4 but on at most 0.05% of the elements, held there at 6e-3 (a
scattered ray's next o and d part by up to 1.6e-4 away from grazing hits
and by up to 5.7e-3 on them, ROADMAP Queue 3; measured 4 of 86,016
elements above 2e-4, at most 3.5e-4); gradients per field (and per ray
component) normalized by the largest value, at test_tapegrad.py:52-129's
2e-4 for the backward on JAX's own tape (which isolates it from the
forward's rounding), against autograd of the replay and against JAX's
tracer, and its 2e-5 for the tracer against the replay."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.grad import tapegrad as jtg
from distributed_raytracer_tpu.ops.pallas.intersect_kernel import (
    closest_hit_pallas as jax_closest_hit_pallas,
)
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.grad import tapegrad as ttg
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import closest_hit_pallas
from test_tapegrad import SceneBuilder, generate_rays, make_camera, setup
from test_torch_scene import to_port

FIELDS = ("centers", "radii", "albedo", "fuzz", "ior")
CONFIGS = [(64, 1), (256, 1), (64, 2), (64, 4)]  # (pool, refill_every)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_grads(d_scene, g_o, g_d):
    return ({k: np.asarray(getattr(d_scene, k)) for k in FIELDS}, np.asarray(g_o),
            np.asarray(g_d))


@pytest.fixture(scope="module")
def case():
    """JAX's forward and backward at each (pool, refill_every), its tracer
    end to end, and the same with K11 (interpret mode) at pool 64."""
    scene, o, d = setup()
    key = jax.random.PRNGKey(3)
    gc = jax.random.normal(jax.random.PRNGKey(11), (o.shape[0], 3))
    runs = {}
    for pool, k in CONFIGS:
        colors, tape, n_it, pos = jax.jit(lambda s, oo, dd: jtg._forward_tape(
            s, oo, dd, key, 8, pool, refill_every=k))(scene, o, d)
        grads = jax.jit(lambda s, g: jtg._backward_tape(s, tape, n_it, pos, g, unroll=k))(
            scene, gc)
        runs[(pool, k)] = dict(colors=np.asarray(colors), fdata=np.asarray(tape.fdata),
                               idata=np.asarray(tape.idata), n_it=int(n_it),
                               pos=np.asarray(pos), grads=_np_grads(*grads))
    # the tracers at test_tapegrad.py:100's smaller shape (K11's interpret
    # mode inside the loop is slow): 16x16, depth 6, key PRNGKey(5)
    s_scene, s_o, s_d = setup(width=16, depth=6)
    s_gc = jax.random.normal(jax.random.PRNGKey(11), (s_o.shape[0], 3))
    tracers = {}
    for name, ifn, pool in (("dense", jtg.closest_hit, 64), ("k11", jax_closest_hit_pallas, 64),
                            ("k11", jax_closest_hit_pallas, 256)):
        tr = jtg.make_tape_tracer(jax.random.PRNGKey(5), 6, pool=pool, intersect_fn=ifn)
        with pltpu.force_tpu_interpret_mode():
            colors, vjp = jax.vjp(lambda s, oo, dd: tr(s, oo, dd), s_scene, s_o, s_d)
            g = vjp(s_gc)
        tracers[(name, pool)] = dict(colors=np.asarray(colors),
                                     grads=({k: np.asarray(getattr(g[0], k)) for k in FIELDS},
                                            np.asarray(g[1]), np.asarray(g[2])))
    small = dict(ts=to_port(s_scene), o=torch.from_numpy(np.array(s_o)),
                 d=torch.from_numpy(np.array(s_d)), gc=torch.from_numpy(np.array(s_gc)))
    return dict(ts=to_port(scene), o=torch.from_numpy(np.array(o)),
                d=torch.from_numpy(np.array(d)), gc=torch.from_numpy(np.array(gc)), runs=runs,
                tracers=tracers, small=small)


def _close(got, want, atol):
    (gs, go, gd), (ws, wo, wd) = got, want
    for name, a, b in [*((k, gs[k], ws[k]) for k in FIELDS), ("ray_o", go, wo),
                       ("ray_d", gd, wd)]:
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=name)


def _tape_floats_close(f, wf):
    """The tape's float columns: within 2e-4 but on grazing rays, at most
    0.05% of the elements, which stand within ROADMAP's 6e-3 for them."""
    dif = np.abs(f - wf)
    assert dif.max() < 6e-3
    assert (dif > 2e-4).mean() <= 5e-4, (dif > 2e-4).sum()


def _t2n(grads):
    g, g_o, g_d = grads
    return {k: v.numpy() for k, v in g.items()}, g_o.numpy(), g_d.numpy()


def test_tape_budget_equals_jax():
    for r in (1, 7, 576, 262144):
        for depth in (1, 8, 50):
            for pool in (32, 64, 2048):
                for k in (1, 2, 3, 4):
                    assert ttg.tape_budget(r, depth, pool, k) == jtg.tape_budget(r, depth, pool,
                                                                                 k)


@pytest.mark.parametrize("pool,refill_every", CONFIGS)
def test_forward_tape_matches_jax(case, pool, refill_every):
    c, want = case, case["runs"][(pool, refill_every)]
    colors, tape, n_it, pos = ttg._forward_tape(c["ts"], c["o"], c["d"], prng.PRNGKey(3), 8,
                                                pool, refill_every=refill_every)
    assert n_it == want["n_it"] and n_it % refill_every == 0
    assert n_it <= ttg.tape_budget(576, 8, min(pool, 576), refill_every)
    np.testing.assert_array_equal(pos.numpy(), want["pos"])
    np.testing.assert_array_equal(tape.idata.numpy(), want["idata"])
    f, wf = tape.fdata.numpy(), want["fdata"]
    np.testing.assert_array_equal(f[..., 12], wf[..., 12])
    np.testing.assert_allclose(f[..., 9:12], wf[..., 9:12], rtol=0, atol=1e-6)
    _tape_floats_close(f, wf)
    dif = np.abs(colors.numpy() - want["colors"])
    assert dif.max() < 5e-4 and dif.mean() < 5e-6


@pytest.mark.parametrize("pool,refill_every", CONFIGS)
def test_backward_on_jax_tape(case, pool, refill_every):
    """The port's reverse walk on JAX's own tape, converted by
    _Tape.from_numpy, against JAX's _backward_tape on it."""
    c, want = case, case["runs"][(pool, refill_every)]
    tape = ttg._Tape.from_numpy(want["fdata"], want["idata"])
    got = ttg._backward_tape(c["ts"], tape, want["n_it"], torch.from_numpy(np.array(want["pos"], np.int64)),
                             c["gc"])
    _close(_t2n(got), want["grads"], 2e-4)


@pytest.mark.parametrize("pool,refill_every", CONFIGS)
def test_backward_matches_replay_autodiff(case, pool, refill_every):
    """test_tapegrad.py:38-97 in the port: the replay reproduces the
    recorded colors, and the backward equals autograd of the replay."""
    c = case
    key = prng.PRNGKey(3)
    colors, tape, n_it, pos = ttg._forward_tape(c["ts"], c["o"], c["d"], key, 8, pool,
                                                refill_every=refill_every)
    p = {k: getattr(c["ts"], k).clone().requires_grad_() for k in FIELDS}
    o, d = c["o"].clone().requires_grad_(), c["d"].clone().requires_grad_()
    replay = ttg.replay_pool_tape(c["ts"].with_diff_params(p), o, d, tape, n_it)
    np.testing.assert_allclose(replay.detach().numpy(), colors.numpy(), rtol=1e-5, atol=1e-6)
    (replay * c["gc"]).sum().backward()
    oracle = ({k: v.grad.numpy() for k, v in p.items()}, o.grad.numpy(), d.grad.numpy())
    got = ttg._backward_tape(c["ts"], tape, n_it, pos, c["gc"])
    _close(_t2n(got), oracle, 2e-4)


def _tracer_grads(tracer, c, g):
    p = {k: getattr(c["ts"], k).clone().requires_grad_() for k in FIELDS}
    o, d = c["o"].clone().requires_grad_(), c["d"].clone().requires_grad_()
    colors = tracer(c["ts"].with_diff_params(p), o, d)
    (colors * g).sum().backward()
    return colors.detach(), ({k: v.grad.numpy() for k, v in p.items()}, o.grad.numpy(),
                             d.grad.numpy())


@pytest.mark.parametrize("pool,refill_every", CONFIGS)
def test_tracer_matches_jax_configs(case, pool, refill_every):
    """make_tape_tracer(use_mega=False) with the dense closest hit against
    JAX's at each (pool, refill_every): its colors and VJP are JAX's
    forward and backward of the fixture (make_tape_tracer's own pair,
    tapegrad.py:1334-1352), colors, scene and ray grads."""
    c, want = case, case["runs"][(pool, refill_every)]
    tracer = ttg.make_tape_tracer(prng.PRNGKey(3), 8, pool=pool, refill_every=refill_every,
                                  device="cpu")
    colors, grads = _tracer_grads(tracer, c, c["gc"])
    dif = np.abs(colors.numpy() - want["colors"])
    assert dif.max() < 5e-4 and dif.mean() < 5e-6
    _close(grads, want["grads"], 2e-4)


@pytest.mark.parametrize("name,pool", [("dense", 64), ("k11", 64), ("k11", 256)])
def test_tracer_matches_jax(case, name, pool):
    """make_tape_tracer(use_mega=False) with the dense closest hit and with
    K11's closest_hit_pallas (its plain version here; JAX's kernel in
    interpret mode) against JAX's tracer: colors, scene and ray grads."""
    c, want = case["small"], case["tracers"][(name, pool)]
    ifn = ttg.closest_hit if name == "dense" else closest_hit_pallas
    tracer = ttg.make_tape_tracer(prng.PRNGKey(5), 6, pool=pool, intersect_fn=ifn,
                                  device="cpu")
    colors, grads = _tracer_grads(tracer, c, c["gc"])
    dif = np.abs(colors.numpy() - want["colors"])
    assert dif.max() < 5e-4 and dif.mean() < 5e-6
    _close(grads, want["grads"], 2e-4)


def test_tracer_end_to_end_matches_replay():
    """test_tapegrad.py:100-129: the tracer's gradient of sum(colors^2)
    against autograd of the replay of the same recorded run, per call key."""
    scene, o, d = setup(width=16, depth=6)
    ts, o, d = to_port(scene), torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    key = prng.PRNGKey(5)
    tracer = ttg.make_tape_tracer(prng.PRNGKey(0), 6, pool=128, device="cpu")
    p = {k: getattr(ts, k).clone().requires_grad_() for k in FIELDS}
    loss = (tracer(ts.with_diff_params(p), o, d, key) ** 2).sum()
    loss.backward()
    assert np.isfinite(loss.item()) and loss.item() > 0
    _, tape, n_it, _ = ttg._forward_tape(ts, o, d, key, 6, 128)
    q = {k: getattr(ts, k).clone().requires_grad_() for k in FIELDS}
    (ttg.replay_pool_tape(ts.with_diff_params(q), o, d, tape, n_it) ** 2).sum().backward()
    for k in FIELDS:
        b = q[k].grad.numpy()
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(p[k].grad.numpy() / scale, b / scale, atol=2e-5, err_msg=k)


def test_depth_exhausted_rays_zero_grad():
    scene = to_port(SceneBuilder()
                    .add_metal((0, 0, -1002), 1000.0, (0.9, 0.9, 0.9), 0.0)
                    .add_metal((0, 0, 1002), 1000.0, (0.9, 0.9, 0.9), 0.0)
                    .build())
    o = torch.zeros(64, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(64, 1)
    f = ttg.make_tape_tracer(prng.PRNGKey(0), 4, pool=32, device="cpu")
    p = {k: getattr(scene, k).clone().requires_grad_() for k in FIELDS}
    colors = f(scene.with_diff_params(p), o, d)
    assert not colors.any()
    colors.sum().backward()
    for name in ("centers", "radii", "albedo"):
        g = p[name].grad
        assert torch.isfinite(g).all() and not g.any(), name


def test_budget_overflow_is_loud(case):
    """A tape budget too small for the run leaves rays unfinished: every
    ray that finished gets a NaN color, so the loss is NaN, not a silently
    truncated image (tapegrad.py:326-342)."""
    c = case
    colors, _, n_it, pos = ttg._forward_tape(c["ts"], c["o"], c["d"], prng.PRNGKey(3), 8, 64,
                                             budget=6)
    assert n_it == 6 and bool((pos >= 0).any()) and bool((pos < 0).any())
    assert bool(torch.isnan(colors[pos >= 0]).all()) and not colors[pos < 0].any()


@pytest.fixture(scope="module")
def fused_case():
    """JAX's _forward_tape with use_fused in interpret mode (its on-core
    draws are zero bits there, all five uniforms 1e-7), and its backward,
    on test_tapegrad.py:200-226's scene."""
    scene = (SceneBuilder()
             .add_lambertian((0, -100.5, -1), 100.0, (0.6, 0.7, 0.2))
             .add_lambertian((0, 0, -1.5), 0.5, (0.7, 0.3, 0.3))
             .build())
    cam = make_camera(aspect_ratio=1.0, image_width=12, max_depth=4)
    ids = jnp.arange(cam.num_pixels, dtype=jnp.int32)
    o, d = generate_rays(cam, jax.random.PRNGKey(7), ids % 12, ids // 12)
    key = jax.random.PRNGKey(2)
    gc = jax.random.normal(jax.random.PRNGKey(11), (o.shape[0], 3))
    with pltpu.force_tpu_interpret_mode():
        colors, tape, n_it, pos = jtg._forward_tape(scene, o, d, key, 4, 64, use_fused=True)
    grads = jtg._backward_tape(scene, tape, n_it, pos, gc)
    return dict(ts=to_port(scene), o=torch.from_numpy(np.array(o)),
                d=torch.from_numpy(np.array(d)), gc=torch.from_numpy(np.array(gc)),
                colors=np.asarray(colors), fdata=np.asarray(tape.fdata),
                idata=np.asarray(tape.idata), n_it=int(n_it), pos=np.asarray(pos),
                grads=_np_grads(*grads))


def test_fused_branch_matches_jax(fused_case, monkeypatch):
    """_forward_tape(use_fused=True) through K10's plain version, handed
    JAX's interpret-mode draws (as tests/test_torch_fused_bounce.py does),
    against JAX's interpret run: control flow equal, colors and tape at the
    bands above; the backward on that tape against JAX's."""
    c = fused_case
    real = ttg.fused_bounce

    def zero_bit_draws(o, d, live, ray_id, arrays, seed):
        return real(o, d, live, ray_id, arrays, seed,
                    draws=[torch.full((o.shape[0],), 1e-7)] * 5)

    monkeypatch.setattr(ttg, "fused_bounce", zero_bit_draws)
    colors, tape, n_it, pos = ttg._forward_tape(c["ts"], c["o"], c["d"], prng.PRNGKey(2), 4,
                                                64, use_fused=True)
    assert n_it == c["n_it"]
    np.testing.assert_array_equal(pos.numpy(), c["pos"])
    np.testing.assert_array_equal(tape.idata.numpy(), c["idata"])
    _tape_floats_close(tape.fdata.numpy(), c["fdata"])
    dif = np.abs(colors.numpy() - c["colors"])
    assert dif.max() < 5e-4 and dif.mean() < 5e-6
    got = ttg._backward_tape(c["ts"], tape, n_it, pos, c["gc"])
    _close(_t2n(got), c["grads"], 2e-4)


def test_fused_forward_fd_albedo(fused_case):
    """The fused branch with its own hash draws and the reverse-tape
    backward against central differences (test_tapegrad.py:200-226)."""
    c = fused_case
    f = ttg.make_tape_tracer(prng.PRNGKey(2), 4, pool=64, use_fused=True, device="cpu")

    def loss(v):
        alb = c["ts"].albedo.clone()
        alb[1, 0] = v
        return (f(c["ts"].with_diff_params({"albedo": alb}), c["o"], c["d"]) ** 2).sum()

    v = torch.tensor(0.7, requires_grad=True)
    loss(v).backward()
    eps = 1e-2
    fd = (float(loss(torch.tensor(0.7 + eps))) - float(loss(torch.tensor(0.7 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(v.grad), fd, rtol=0.08, atol=1e-5)


def test_mega_plain_backward_equals_mega_bwd(case):
    """use_mega=True, mega_bwd=False (K6, then the plain tensor-code walk)
    against mega_bwd=True (K6, then K7): on the CPU both walks are K7's
    plain version, so equal bit for bit (on the card K7's band holds,
    tests/test_torch_cuda.py)."""
    c = case
    out = []
    for mega_bwd in (False, True):
        tr = ttg.make_tape_tracer(prng.PRNGKey(3), 8, use_mega=True, mega_bwd=mega_bwd,
                                  device="cpu")
        colors, grads = _tracer_grads(tr, c, c["gc"])
        out.append((colors, grads))
    assert torch.equal(out[0][0], out[1][0])
    _close(out[0][1], out[1][1], 0.0)
    with pytest.raises(ValueError, match="mega_bwd requires use_mega"):
        ttg.make_tape_tracer(prng.PRNGKey(3), 8, mega_bwd=True, device="cpu")
    # an int seed where the key belongs (the signature before JAX's) is refused
    with pytest.raises(TypeError, match="key"):
        ttg.make_tape_tracer(123456, 8, use_mega=True, mega_bwd=True, device="cpu")


@pytest.mark.parametrize("use_fused", [False, True])
def test_scene_changed_in_place_before_backward_refused(use_fused):
    """The host-loop tracer keeps the scene and its tape for the backward
    through autograd's saved tensors: a scene field changed in place between
    forward and backward (an optimizer step on a retained graph) raises,
    where it would give the gradients of another scene."""
    scene, o, d = setup(width=8, depth=3)
    ts, o, d = to_port(scene), torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    tracer = ttg.make_tape_tracer(prng.PRNGKey(0), 3, pool=32, use_fused=use_fused,
                                  device="cpu")
    p = {k: getattr(ts, k).clone().requires_grad_() for k in FIELDS}
    loss = tracer(ts.with_diff_params(p), o, d).sum()
    with torch.no_grad():
        p["centers"].add_(0.01)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        loss.backward()
