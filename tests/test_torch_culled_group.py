"""The group walk of the culled kernels (csrc/trace.cuh group_walk: K14 and
K12/K13 run G lanes per ray) as a plain schedule model,
ops/kernels/culled_kernel.py::group_walk_plain, against the walk of one
thread per ray, on the CPU; no JAX.

The model runs the kernel's schedule: a prefilter of G chunk positions at
once against the best t at the window's start, an exact recheck of each
candidate once best has fallen, the admitted chunk's slots dealt to the
lanes (lane q: slots q, q + G, ...), each lane's first least t and the
group's least (t, slot).  It must give the plain versions' t and idx bit
for bit (culled_closest_hit_plain over a block plan, for K12 and K13;
culled_fused_bounce_plain over the scene's own chunk order, for K14) and
every counter that the walk of one thread per ray gives (bound tests,
chunks admitted, slot tests, tests with disc >= 0), for G = 1, 4, 8 and
32.  The scene is synthetic: a ground sphere in an always-swept chunk,
300 small spheres in chunks of 16, two identical spheres in one chunk (an
exact tie inside a chunk); the rays include grazing ones, misses, rays at
the twins and, for the bounce, inactive lanes.  Ties across chunks are
left out (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.core.vecmath import BIG
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
from distributed_raytracer_tpu_torch.ops.kernels.bounce import sweep_t
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import sphere_pack

torch.set_num_threads(1)
CHUNK = 16
GROUPS = [1, 4, 8, 32]
N_SMALL = 300
TWIN = 7  # sphere TWIN and sphere N_SMALL + 1 are the same sphere


def _scene():
    """The ground (radius 1000), N_SMALL spheres of radius 0.15-0.6 over a
    24 x 24 patch, and a copy of sphere TWIN, in random materials."""
    rng = np.random.default_rng(3)
    centers = rng.uniform([-12.0, 0.2, -12.0], [12.0, 3.0, 12.0], size=(N_SMALL, 3))
    radii = rng.uniform(0.15, 0.6, N_SMALL)
    centers = np.concatenate([[[0.0, -1000.0, 0.0]], centers, centers[TWIN:TWIN + 1]])
    radii = np.concatenate([[1000.0], radii, radii[TWIN:TWIN + 1]])
    n = len(radii)
    return Scene.from_numpy(dict(
        centers=centers, radii=radii, albedo=rng.uniform(0.1, 0.9, (n, 3)),
        mat_type=rng.integers(0, 3, n), fuzz=rng.uniform(0.0, 0.5, n),
        ior=np.full(n, 1.5)), "cpu")


def _rays(scene):
    """[R, 3] origins and directions, R = 325: rays from above the patch
    at random points of it and grazing rays (aimed at a sphere's rim),
    then, in the plan's last block of 128 rays, rays at the twins from
    just above them and rays into the sky, which reach few chunks."""
    rng = np.random.default_rng(4)
    c = scene.centers.numpy().astype(np.float64)
    r = scene.radii.numpy().astype(np.float64)

    def origins(k):
        return rng.uniform([-16.0, 1.0, -16.0], [16.0, 7.0, 16.0], size=(k, 3))

    o1 = origins(192)
    d1 = rng.uniform([-12.0, 0.0, -12.0], [12.0, 3.0, 12.0], size=(192, 3)) - o1
    o2 = origins(64)
    k = rng.integers(1, N_SMALL + 1, 64)
    perp = np.cross(c[k] - o2, rng.normal(size=(64, 3)))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    d2 = c[k] + r[k, None] * perp - o2
    o3 = c[1 + TWIN] + rng.uniform([-1.0, 1.5, -1.0], [1.0, 2.5, 1.0], size=(48, 3))
    d3 = c[1 + TWIN] + 0.3 * r[1 + TWIN] * rng.normal(size=(48, 3)) - o3
    o4 = o3[:21] + [0.0, 0.5, 0.0]
    d4 = rng.normal(size=(21, 3)) * 0.2 + [0.0, 1.0, 0.0]
    o = np.concatenate([o1, o2, o3, o4]).astype(np.float32)
    d = np.concatenate([d1, d2, d3, d4]).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module")
def setup():
    scene = _scene()
    culled = ck.build_culled_scene(scene, chunk=CHUNK)
    o, d = _rays(scene)
    return culled, o, d


def _sequential_counts(o, d, sph, bounds, plan, n_pos, lens, chunk):
    """The walk of one thread per ray reckoned whole: along each ray's plan,
    the best t before a position is the least chunk minimum of the
    positions before it (a chunk that the conservative bound test rejects
    holds no nearer hit), and a chunk is admitted by chunk_admits against
    it.  Returns the counts of GROUP_COUNTS that this walk also gives."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    t, ok = sweep_t(ox, oy, oz, dx, dy, dz, a, 1.0 / a, sph.t())
    r, n_chunks = o.shape[0], lens.shape[0]
    swept = (torch.arange(chunk)[None, :] < lens[:, None].long())[None]
    t_c = torch.where(swept, t.view(r, n_chunks, chunk), BIG).amin(2).gather(1, plan)
    near_c = (ok.view(r, n_chunks, chunk) & swept).sum(2).gather(1, plan)
    live = torch.arange(plan.shape[1])[None, :] < n_pos[:, None]
    before = torch.cat([torch.full_like(t_c[:, :1], BIG),
                        torch.where(live, t_c, BIG).cummin(1).values[:, :-1]], 1)
    b = bounds[plan]
    adm = live & ck.chunk_admits_plain(b, ox, oy, oz, dx, dy, dz, a, 1.0 / a, before)
    return dict(bound_tests=int((live & torch.isfinite(b[..., 3])).sum()),
                admitted=int(adm.sum()), tests=int((adm * lens.long()[plan]).sum()),
                near=int((adm * near_c).sum()))


def _plan(culled, o, d, mode):
    """The block plan of K12 (grid: every position) or K13 (walk: the
    first n_visit), blocks of 128 rays, and each ray's row of it."""
    br, nb = ck.plan_blocks(o.shape[0], block_rays=ck.LANE)
    order, n_visit = ck.block_visit_plan(o, d, torch.from_numpy(culled.bounds_c),
                                         torch.from_numpy(culled.bounds_r2), nb, br)
    block = torch.arange(o.shape[0]) // br
    rows = order.long()[block]
    n_pos = n_visit.long()[block] if mode == "walk" else torch.full_like(block, order.shape[1])
    return br, order, rows, n_pos


def test_scene_holds_the_cases(setup):
    """The twins share a chunk, the ground has an always-swept chunk, some
    rays graze and some miss."""
    culled, o, d = setup
    slot = {int(s): i for i, s in enumerate(culled.order) if s >= 0}
    assert slot[1 + TWIN] // CHUNK == slot[N_SMALL + 1] // CHUNK
    assert np.isinf(culled.bounds_r2[slot[0] // CHUNK])
    assert culled.bounds_r2.shape[0] >= 20
    sph = sphere_pack(culled.scene.centers, culled.scene.radii)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    t, _ = sweep_t(ox, oy, oz, dx, dy, dz, a, 1.0 / a, sph.t())
    tmin, idx = t.min(1)
    twins = sorted((slot[1 + TWIN], slot[N_SMALL + 1]))
    assert int((idx == twins[0]).sum()) >= 10  # the first twin wins the exact ties
    assert torch.equal(t[:, twins[0]], t[:, twins[1]])
    assert int((tmin >= BIG).sum()) >= 10
    c = culled.scene.centers[idx.clamp(0)].double() - o.double()
    h = (d.double() * c).sum(-1)
    disc = h * h - (d.double() ** 2).sum(-1) * ((c * c).sum(-1)
                                                 - culled.scene.radii[idx].double() ** 2)
    assert int(((tmin < BIG) & (disc < 1e-3 * h * h)).sum()) >= 10


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("mode", ["grid", "walk"])
def test_group_walk_matches_culled_closest_hit(setup, mode, group):
    """K12 (grid) and K13 (walk) on the group schedule: t and idx equal
    culled_closest_hit_plain's bit for bit, the counters the walk of one
    thread per ray's, and the issued lanes G x ceil(chunk / G) a chunk."""
    culled, o, d = setup
    sph = sphere_pack(culled.scene.centers, culled.scene.radii)
    bounds = ck.culled_bounds(culled, "cpu")
    br, order, rows, n_pos = _plan(culled, o, d, mode)
    lens = torch.full((order.shape[1],), CHUNK, dtype=torch.int32)
    t, idx, n = ck.group_walk_plain(o, d, sph, bounds, rows, n_pos, lens, CHUNK, group)
    t_p, idx_p = ck.culled_closest_hit_plain(o, d, sph, order, CHUNK, br)
    assert torch.equal(t, t_p)
    assert torch.equal(idx, idx_p)
    want = _sequential_counts(o, d, sph, bounds, rows, n_pos, lens, CHUNK)
    assert {k: n[k] for k in want} == want
    assert n["issued"] == n["admitted"] * group * -(-CHUNK // group)
    if mode == "walk":  # the plan leaves some chunks out
        assert want["bound_tests"] < o.shape[0] * (order.shape[1] - 1)


@pytest.mark.parametrize("group", GROUPS)
def test_group_walk_matches_culled_bounce(setup, group):
    """K14 on the group schedule over the pack's own chunk order, every
    third lane inactive (an inactive lane is swept all the same): the
    winner and hit of culled_fused_bounce_plain bit for bit, t the dense
    least t, and its counters (chunks admitted, slot tests, tests with
    disc >= 0; the walk of one thread per ray's, counted by walk_sweep)."""
    culled, o, d = setup
    pack = cb.build_culled_pack(culled)
    r = o.shape[0]
    act = torch.arange(r) % 3 != 2
    rid = torch.arange(r, dtype=torch.int32) * 7 + 13
    stats = torch.zeros(4, dtype=torch.int64)
    out = cb.culled_fused_bounce_plain(o, d, act, rid, pack, 2468, stats=stats)
    plan = torch.arange(pack.n_chunks).expand(r, -1)
    n_pos = torch.full((r,), pack.n_chunks)
    t, idx, n = ck.group_walk_plain(o, d, pack.scene_pack, pack.bounds, plan, n_pos,
                                    pack.chunk_len, pack.chunk, group)
    assert torch.equal(idx, out.idx)
    assert torch.equal(t < BIG * 0.5, out.hit)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    t_dense, _ = sweep_t(ox, oy, oz, dx, dy, dz, a, 1.0 / a, pack.scene_pack.t())
    assert torch.equal(t, t_dense.min(1).values)
    assert [n["admitted"], n["tests"], n["near"]] == stats[1:].tolist()
    assert n["bound_tests"] == r * int(torch.isfinite(pack.bounds[:pack.n_chunks, 3]).sum())
    assert n["tests"] <= n["issued"] < n["tests"] + n["admitted"] * group


def test_recheck_is_exercised(setup):
    """G = 1 is the walk of one thread per ray (its prefilter is exact, so
    the recheck rejects nothing); at G >= 4 the stale prefilter passes
    chunks that the recheck rejects, and the result is the same."""
    culled, o, d = setup
    sph = sphere_pack(culled.scene.centers, culled.scene.radii)
    bounds = ck.culled_bounds(culled, "cpu")
    _, order, rows, n_pos = _plan(culled, o, d, "grid")
    lens = torch.full((order.shape[1],), CHUNK, dtype=torch.int32)
    runs = {g: ck.group_walk_plain(o, d, sph, bounds, rows, n_pos, lens, CHUNK, g)
            for g in GROUPS}
    assert runs[1][2]["rechecked_out"] == 0
    assert runs[1][2]["issued"] == runs[1][2]["tests"]
    for g in GROUPS[1:]:
        assert runs[g][2]["rechecked_out"] > 0
        assert torch.equal(runs[g][0], runs[1][0]) and torch.equal(runs[g][1], runs[1][1])
