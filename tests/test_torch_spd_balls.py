"""The SPD `balls` sphereflake (benchmark/reference/generators/spd_balls.py)
and the port's walk on it, on the CPU: the flake is the one Haines' balls.c
writes (count, the first child's printed digits, tangency, the 6 + 3
layout about each parent's direction, the lowest point, no overlap); at
size factor 3 (820 spheres, past one dense sweep) render_progressive's
walk and the walk tracer's loss and gradients meet the benchmark's plain
reference; the walk's tally and the pack's profiler range count what ran.
No JAX."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import camera as ref_camera
from benchmark.reference import draws, tracer
from benchmark.reference.scenes import GENERATOR_DIR, METAL, make_scene
from distributed_raytracer_tpu_torch.grad.diff_render import image_loss
from distributed_raytracer_tpu_torch.grad.tapegrad import make_tape_camera_walk_tracer
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import camera_scalar_row, make_camera
from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel as mwk
from distributed_raytracer_tpu_torch.render.progressive import batch_seeds, render_progressive

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "spd_balls.json").read_text())
RUN_SEED = 2**33 + 19
BS, CS = 123457, 7654321
FIELDS = ("centers", "radii", "albedo", "fuzz", "ior")


def _generator():
    spec = importlib.util.spec_from_file_location("spd_balls", GENERATOR_DIR / "spd_balls.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _generator()


@pytest.fixture(scope="module")
def flake4():
    return GEN.flake(4)


@pytest.mark.parametrize("size_factor,count", [(1, 10), (2, 91), (3, 820), (4, 7381)])
def test_sphere_count(size_factor, count):
    assert len(GEN.flake(size_factor)["radii"]) == count
    assert len(GEN.make(0, size_factor)["radii"]) == count


def test_second_sphere_is_the_spd_first_child(flake4):
    got = np.append(flake4["centers"][1], flake4["radii"][1])
    np.testing.assert_array_equal(np.round(got, 6), [0.272166, 0.272166, 0.544331, 0.166667])
    assert flake4["parent"][1] == 0 and flake4["level"][1] == 1


def test_every_child_is_tangent_to_its_parent(flake4):
    c, r, up = flake4["centers"], flake4["radii"], flake4["parent"]
    kids = np.nonzero(up >= 0)[0]
    np.testing.assert_allclose(r[kids], r[up[kids]] / 3.0, rtol=1e-12)
    dist = np.linalg.norm(c[kids] - c[up[kids]], axis=1)
    np.testing.assert_allclose(dist, r[kids] + r[up[kids]], rtol=1e-12)


def _azimuths(v, u):
    """Degrees of each v about u, in a basis of the plane normal to u."""
    a = np.cross(u, [1.0, 0.0, 0.0] if abs(u[0]) < 0.9 else [0.0, 1.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(u, a)
    return np.degrees(np.arctan2(v @ b, v @ a)) % 360.0


def _gaps(deg):
    s = np.sort(deg)
    return np.diff(np.append(s, s[0] + 360.0))


def test_children_lie_six_flat_and_three_raised_about_each_direction(flake4):
    up, dirs = flake4["parent"], flake4["directions"]
    parents = np.unique(up[up >= 0])
    assert len(parents) == 1 + 9 + 81 + 729
    raised = np.sqrt(2.0 / 3.0)  # sin of asin(sqrt(2/3)) = 54.7356 degrees
    for p in parents:
        kids = np.nonzero(up == p)[0]
        u, v = dirs[p], dirs[kids]
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-12)
        elev = v @ u
        # balls.c's acos(u_z) about a direction near the pole is good to ~1e-8
        flat = np.abs(elev) < 1e-6
        high = np.abs(elev - raised) < 1e-6
        assert flat.sum() == 6 and high.sum() == 3 and (flat | high).all()
        assert high.tolist() == [True, False, False] * 3  # balls.c's order
        az = _azimuths(v, u)
        np.testing.assert_allclose(_gaps(az[flat]), 60.0, atol=1e-4)
        np.testing.assert_allclose(_gaps(az[high]), 120.0, atol=1e-4)
        # each raised direction sits midway between two flat ones
        off = (az[high][:, None] - az[flat][None, :]) % 60.0
        np.testing.assert_allclose(off, 30.0, atol=1e-4)
    # about the root's +z: flat at 15 + 60k degrees, raised at 45 + 120k
    first = dirs[up == 0]
    az = np.degrees(np.arctan2(first[:, 1], first[:, 0])) % 360.0
    np.testing.assert_allclose(np.sort(az[np.abs(first[:, 2]) < 1e-9]),
                               15.0 + 60.0 * np.arange(6), atol=1e-9)
    np.testing.assert_allclose(np.sort(az[first[:, 2] > 0.5]), 45.0 + 120.0 * np.arange(3),
                               atol=1e-9)


def test_children_follow_their_parent_depth_first(flake4):
    up, level = flake4["parent"], flake4["level"]
    # a sphere's subtree is the block of 1 + 9 + ... rows right after it
    size = {4 - k: sum(9**j for j in range(k + 1)) for k in range(5)}
    for i in np.nonzero(level < 4)[0][:200]:
        n = size[level[i]]
        kids = np.nonzero(up[i + 1:i + n] == i)[0] + i + 1
        assert len(kids) == 9 and kids[0] == i + 1
        assert np.array_equal(np.diff(kids), np.full(8, size[level[i] + 1]))


def test_lowest_point_is_the_ground_height(flake4):
    assert (flake4["centers"][:, 2] - flake4["radii"]).min() == -0.5


def test_no_two_spheres_overlap(flake4):
    c, r = flake4["centers"], flake4["radii"]
    worst = np.inf
    for i in range(0, len(r), 1024):
        blk = slice(i, i + 1024)
        gap = np.linalg.norm(c[blk, None] - c[None], axis=-1) - (r[blk, None] + r[None])
        rows = np.arange(gap.shape[0])
        gap[rows, rows + i] = np.inf
        worst = min(worst, gap.min())
    assert worst > -1e-12


def test_every_sphere_is_the_flake_mirror_and_the_seed_draws_nothing():
    a, b = GEN.make(1, 3), GEN.make(2**40 + 5, 3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert (a["mat"] == METAL).all() and (a["fuzz"] == 0.0).all()
    np.testing.assert_array_equal(a["albedo"], np.tile(np.float32([0.5, 0.45, 0.35]), (820, 1)))
    assert a["centers"].dtype == np.float32


# ---- the port's walk on the flake, at size factor 3 ----

def _cam_entry(width: int, depth: int, spp: int) -> dict:
    return {**CONFIG["camera"], "image_width": width, "max_depth": depth,
            "samples_per_pixel": spp}


def _port(arrays: dict, cam: dict):
    scene = Scene.from_numpy(dict(centers=arrays["centers"], radii=arrays["radii"],
                                  albedo=arrays["albedo"], mat_type=arrays["mat"],
                                  fuzz=arrays["fuzz"], ior=arrays["ior"]), "cpu")
    camera = make_camera(aspect_ratio=cam["aspect_ratio"], image_width=cam["image_width"],
                         samples_per_pixel=cam["samples_per_pixel"], max_depth=cam["max_depth"],
                         vfov=cam["vfov"], lookfrom=tuple(cam["lookfrom"]),
                         lookat=tuple(cam["lookat"]), vup=tuple(cam["vup"]),
                         defocus_angle=cam["defocus_angle"], focus_dist=cam["focus_dist"])
    return scene, camera


@pytest.fixture(scope="module")
def wide():
    arrays = make_scene({**CONFIG["scene"], "size_factor": 3}, RUN_SEED)
    cam = _cam_entry(16, 8, 4)
    scene, camera = _port(arrays, cam)
    assert scene.num_spheres == 820 and camera.image_height == 16
    return arrays, cam, scene, camera


def _reference_sum(arrays, cam, seed: int, spp: int, batch: int) -> np.ndarray:
    """[n_pix, 3] color sum of the reference over spp samples in batches,
    summed as render_progressive sums them."""
    w, h = ref_camera.image_size(cam)
    n = w * h
    p = torch.arange(n)
    s = tracer.Spheres(arrays, "cpu")
    total = torch.zeros(n, 3)
    for done in range(0, spp, batch):
        bs, cs = draws.batch_seeds(seed, done)
        acc = None
        for k in range(min(batch, spp - done)):
            rid = (k * n + p) & draws.M32
            o, d = ref_camera.primary_rays(ref_camera.camera_row(cam), p, rid, cs, w)
            c = tracer.trace(s, o, d, rid, bs, int(cam["max_depth"]))
            acc = c if acc is None else acc + c
        total = total + acc
    return total.numpy()


def test_progressive_walk_meets_the_reference(wide):
    arrays, cam, scene, camera = wide
    seed = 2**31 + 77
    st = render_progressive(scene, camera, seed=seed, spp=4, batch=3, engine="mega",
                            device="cpu")
    ref = _reference_sum(arrays, cam, seed, 4, 3)
    assert st.raw_sum.shape == ref.shape == (256, 3)
    assert (ref > 0).any(axis=1).all()
    np.testing.assert_allclose(st.raw_sum, ref, rtol=1e-5, atol=1e-6)


def test_walk_tracer_loss_and_gradients_meet_the_reference(wide):
    from benchmark.drivers.scene_grad import field_rel_err, sphere_p90_rel_err

    arrays, cam, scene, _ = wide
    camera = _port(arrays, {**cam, "samples_per_pixel": 1})[1]
    n = camera.num_pixels
    target = torch.rand(n, 3, generator=torch.Generator().manual_seed(5))
    params = {k: getattr(scene, k).detach().clone().requires_grad_() for k in FIELDS}
    tr = make_tape_camera_walk_tracer(camera, BS, CS, scene, chunk=256, device="cpu")
    loss = image_loss(tr(scene.with_diff_params(params), torch.arange(n)), target)
    loss.backward()

    s = tracer.Spheres(arrays, "cpu", grad=True)
    p = torch.arange(n)
    o, d = ref_camera.primary_rays(ref_camera.camera_row(cam), p, p, CS, camera.image_width)
    ref_loss = torch.mean((tracer.trace(s, o, d, p, BS, int(cam["max_depth"])) - target) ** 2)
    ref_loss.backward()
    assert abs(loss.item() - ref_loss.item()) <= 1e-6 * ref_loss.item()
    ref = s.leaves()
    for k in ("centers", "radii", "albedo", "fuzz"):
        g, r = params[k].grad, ref[k].grad
        assert float(r.norm()) > 0, k
        assert sphere_p90_rel_err(g, r) < 1e-3, k
        assert field_rel_err(g, r, float(r.norm()))[0] < 1e-3, k
    assert float(params["ior"].grad.abs().max()) == 0.0  # mirrors only: ior is never read


def test_walk_tally_is_the_plain_walks_stats(wide):
    _, _, scene, camera = wide
    mwk.walk_tally()  # start from nothing
    assert mwk.walk_tally() is None
    seed, spp, batch = 99, 3, 2
    render_progressive(scene, camera, seed=seed, spp=spp, batch=batch, engine="mega",
                       device="cpu")
    got = mwk.walk_tally()
    assert mwk.walk_tally() is None  # read and reset

    pack = mwk.walk_pack_for(scene, camera, chunk=256)
    n = camera.num_pixels
    want = torch.zeros(len(mwk.STATS), dtype=torch.int64)
    for done in range(0, spp, batch):
        bs, cs = batch_seeds(seed, done)
        for k in range(min(batch, spp - done)):
            want += mwk.mega_walk_sample_plain(
                pack.scene_pack, pack.attrs, pack.bounds, pack.chunk_len,
                camera_scalar_row(camera), bounce_seed=bs, cam_seed=cs, rid_base=k * n,
                pix0=0, n_valid=n, n_cap=n, w=camera.image_width,
                max_depth=camera.max_depth)[1]
    assert got == {**dict(zip(mwk.STATS, want.tolist())), "chunks": pack.n_chunks}
    assert pack.n_chunks == 4 and 0 < got["tests"] < got["bounces"] * scene.num_spheres


def test_walk_pack_range_and_counters(wide):
    _, _, scene, camera = wide
    builds, secs = render_progressive.walk_packs, render_progressive.walk_pack_s
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        render_progressive(scene, camera, seed=1, spp=1, engine="mega", device="cpu")
    names = [e.name for e in prof.events()]
    assert names.count("render_progressive.walk_pack") == 1
    assert render_progressive.walk_packs == builds + 1
    assert render_progressive.walk_pack_s > secs
