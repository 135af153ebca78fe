"""The port's distributed layer as real multi-process jobs on the CPU:
gloo, rendezvous through a file under tmp_path (no port to race for),
every worker under a hard timeout (all of a job's processes are killed if
one overruns).  The workers (tests/_torch_multihost_worker.py and the CLI)
import the port only; this parent holds their outputs against the port's
single-process runs and JAX's single-device references.

- render-dist --cpu, scan and mega engines, 2 ranks: rank 0's image is the
  1-rank image byte for byte.
- one camera-dp training step at 2 ranks: the 1-rank colors bit for bit,
  the all-reduced gradients within the atomics band.
- a 2 x 2 (rays x scene) mesh of 4 ranks: closest_hit_sharded (the dense
  sweep, and K11's plain version, as the local sweep) equal to the closest
  hit on the padded unsplit scene; gather_params_sharded; the scene-sharded
  render against the loop over (sample, rays shard) of
  tests/test_parallel.py:160-178 at its band (atol 1e-4) and the grad fn
  against jax.value_and_grad of that loop (5e-4 of each field's max); the
  2D tape tracer bit for bit with the rays-dp tracer."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.camera import generate_rays as jax_generate_rays
from distributed_raytracer_tpu.ops.camera import make_camera as jax_make_camera
from distributed_raytracer_tpu.ops.intersect import closest_hit as jax_closest_hit
from distributed_raytracer_tpu.ops.trace import trace_rays as jax_trace_rays
from distributed_raytracer_tpu.parallel.scene_sharded import shard_scene as jax_shard_scene
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.grad.diff_render import image_loss
from distributed_raytracer_tpu_torch.grad.tapegrad import make_tape_camera_tracer
from distributed_raytracer_tpu_torch.models.presets import final_scene_camera, rtiow_final_scene
from distributed_raytracer_tpu_torch.ops.camera import generate_rays
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import closest_hit_pallas
from distributed_raytracer_tpu_torch.ops.materials import gather_hit_params
from distributed_raytracer_tpu_torch.parallel import Mesh, make_tape_dp_tracer, shard_scene
from test_torch_parallel import jax_scene_and_cam

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_multihost_worker.py"
TIMEOUT_S = 120
DIFF = ("centers", "radii", "albedo", "fuzz", "ior")
sys.path.insert(0, str(WORKER.parent))
import _torch_multihost_worker as worker  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_job(cmds):
    """Start every rank's command, wait for all under one hard timeout,
    kill the whole job if any overruns; assert every rank exited 0."""
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a rank overran {TIMEOUT_S} s: {cmds}")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def run_workers(task, world, outdir):
    init = outdir / f"{task}.init"
    run_job([[sys.executable, str(WORKER), task, str(r), str(world), str(init), str(outdir)]
             for r in range(world)])
    return [dict(np.load(outdir / f"{task}_{r}.npz")) for r in range(world)]


def band(got, want, tol, name=""):
    scale = np.abs(want).max() + 1e-8
    err = np.abs(got - want).max() / scale
    assert err <= tol, (name, err)


# ---- render-dist ----

@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_render_dist_two_ranks_equal_one(tmp_path, engine):
    cli = [sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", "render-dist", "--cpu",
           "--config", "config2", "--width", "31", "--spp", "3", "--batch", "2", "--engine",
           engine]
    init = tmp_path / "init"
    run_job([cli + ["--coordinator", f"file://{init}", "--num-processes", "2", "--process-id",
                    str(r), "--out", str(tmp_path / "two.ppm")] for r in range(2)])
    run_job([cli + ["--batch", "3", "--out", str(tmp_path / "one.ppm")]])
    two, one = (tmp_path / "two.ppm").read_bytes(), (tmp_path / "one.ppm").read_bytes()
    assert two == one and len(one) > 31 * 15 * 3


# ---- one camera-dp training step ----

def test_camera_dp_step_two_ranks(tmp_path):
    ranks = run_workers("camera_step", 2, tmp_path)
    scene = rtiow_final_scene(seed=0, pad_to=512)
    cam = final_scene_camera(31).replace(max_depth=5)
    n = cam.num_pixels
    target = torch.from_numpy(np.random.default_rng(2).random((n, 3)).astype(np.float32))
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in DIFF}
    cols = make_tape_camera_tracer(cam, 7, 8, iota_pix=True, device="cpu")(
        scene.with_diff_params(leaves), torch.zeros(n))
    image_loss(cols, target).backward()
    for r in ranks:
        np.testing.assert_array_equal(r["colors"], cols.detach().numpy())
        for k in DIFF:
            band(r[k], leaves[k].grad.numpy(), 1e-5, k)  # the same sum in another order


# ---- the 2 x 2 scene-sharded mesh ----

@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    return run_workers("scene_sharded", 4, tmp_path_factory.mktemp("scene_sharded"))


@pytest.fixture(scope="module")
def padded():
    return shard_scene(worker.parallel_scene(), 2)


def test_closest_hit_sharded(sharded_run, padded):
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.uniform(-3, 3, (64, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    dense, k11 = closest_hit(o, d, padded), closest_hit_pallas(o, d, padded)
    js, _ = jax_scene_and_cam()
    want = jax_closest_hit(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jax_shard_scene(js, 2))
    for r in sharded_run:
        # every rank holds the global hit: the unsplit sweep's, bit for bit
        np.testing.assert_array_equal(r["hit_dense_t"], dense.t.numpy())
        np.testing.assert_array_equal(r["hit_dense_idx"], dense.idx.numpy())
        np.testing.assert_array_equal(r["hit_k11_t"], k11.t.numpy())
        np.testing.assert_array_equal(r["hit_k11_idx"], k11.idx.numpy())
        h = np.asarray(want.hit)
        np.testing.assert_array_equal(r["hit_dense_t"] < 1e29, h)
        np.testing.assert_allclose(r["hit_dense_t"][h], np.asarray(want.t)[h], rtol=1e-6)
        np.testing.assert_array_equal(r["hit_dense_idx"][h], np.asarray(want.idx)[h])


def test_gather_params_sharded(sharded_run, padded):
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, padded.num_spheres, 32))
    want = gather_hit_params(padded, idx)
    for r in sharded_run:
        for k, v in want.items():
            np.testing.assert_array_equal(r[f"params_{k}"], v.numpy(), err_msg=k)


def _jax_loop(params, js_padded, jc, key, samples, ids, n_rays):
    """tests/test_parallel.py:160-178: per (sample, rays shard) keys
    fold_in(fold_in(key, s), shard), the replicated scene's trace."""
    w = jc.image_width
    shard = ids.shape[0] // n_rays
    sc = js_padded.replace(**params)
    parts = []
    for rs in range(n_rays):
        tids = ids[rs * shard:(rs + 1) * shard]
        acc = jnp.zeros((shard, 3), jnp.float32)
        for s in samples:
            k_cam, k_trace = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, s), rs))
            o, d = jax_generate_rays(jc, k_cam, tids % w, tids // w)
            acc = acc + jax_trace_rays(sc, o, d, k_trace, jc.max_depth)
        parts.append(acc)
    return jnp.concatenate(parts)


@pytest.fixture(scope="module")
def jax_2d():
    js, _ = jax_scene_and_cam()
    jpad = jax_shard_scene(js, 2)
    jc = jax_make_camera(aspect_ratio=2.0, image_width=31, samples_per_pixel=4, max_depth=6)
    n = jc.image_width * jc.image_height
    ids = jnp.asarray(np.r_[np.arange(n), 0], jnp.int32)
    params = {k: getattr(jpad, k) for k in DIFF}
    render = np.asarray(jax.jit(lambda p: _jax_loop(p, jpad, jc, jax.random.PRNGKey(7), [0, 1],
                                                    ids, 2))(params))
    target = np.random.default_rng(3).random((n, 3)).astype(np.float32)

    def loss(p):
        img = _jax_loop(p, jpad, jc, jax.random.PRNGKey(3), [0], ids, 2)[:n]
        return jnp.sum((img - target) ** 2) / (3.0 * n)

    lv, g = jax.jit(jax.value_and_grad(loss))(params)
    return n, render, float(lv), {k: np.asarray(v) for k, v in g.items()}


def test_scene_sharded_render_matches_jax_loop(sharded_run, jax_2d):
    n, want, _, _ = jax_2d
    # rank (a, k): rays shard a; the two ranks of a row hold the same rays
    got = np.concatenate([sharded_run[0]["render"], sharded_run[2]["render"]])
    np.testing.assert_array_equal(sharded_run[0]["render"], sharded_run[1]["render"])
    np.testing.assert_array_equal(sharded_run[2]["render"], sharded_run[3]["render"])
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-4)


def test_scene_sharded_grad_fn_matches_jax(sharded_run, jax_2d):
    _, _, want_loss, want = jax_2d
    for r in sharded_run:
        np.testing.assert_allclose(float(r["loss"]), want_loss, rtol=1e-5)
    n_local = sharded_run[0]["grad_radii"].shape[0]
    for k in DIFF:
        # rank (0, k) holds block k's gradients; rank (1, k) the same (summed over rays)
        got = np.concatenate([sharded_run[0][f"grad_{k}"], sharded_run[1][f"grad_{k}"]])
        assert got.shape[0] == 2 * n_local
        np.testing.assert_array_equal(sharded_run[0][f"grad_{k}"], sharded_run[2][f"grad_{k}"])
        band(got, want[k], 5e-4, k)


def test_tape_2d_tracer_equals_rays_dp_tracer(sharded_run, padded):
    ids = torch.arange(128)
    cam = worker.camera(32)
    o, d = generate_rays(cam, ids % 32, ids // 32, key=prng.PRNGKey(5))
    dp = make_tape_dp_tracer(Mesh(n_rays=2), prng.PRNGKey(9), 6, pool=32, device="cpu")
    leaves = {k: getattr(padded, k).clone().requires_grad_() for k in DIFF}
    dd = d.clone().requires_grad_()
    parts = [dp.local(padded.with_diff_params(leaves), o, dd, a) for a in range(2)]
    sum((p ** 2).sum() for p in parts).backward()
    n_local = padded.num_spheres // 2
    for rank, r in enumerate(sharded_run):
        a, k = divmod(rank, 2)
        np.testing.assert_array_equal(r["tape_colors"], parts[a].detach().numpy())
        np.testing.assert_array_equal(r["tape_d"][a * 64:(a + 1) * 64],
                                      dd.grad[a * 64:(a + 1) * 64].numpy())
        for f in DIFF:
            g = r[f"tape_{f}"]
            blk = slice(k * n_local, (k + 1) * n_local)
            band(g[blk], leaves[f].grad[blk].numpy(), 1e-6, f)
            assert not np.delete(g, np.arange(k * n_local, (k + 1) * n_local), 0).any()
