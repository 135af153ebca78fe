"""The group-per-ray kernels of the port at several lanes per ray (G) and
block sizes, on one CUDA card: the dense sweep (csrc/trace.cuh
group_sweep: K10 in csrc/fused_bounce.cu, K11 in csrc/intersect.cu) and
the culled walk (group_walk: K14 in csrc/fused_bounce.cu, K12/K13 in
csrc/culled_intersect.cu).

    python3 scripts/torch_group_probe.py [--kernels dense,culled] [--groups G,...]
                                         [--threads 128,256,512] [--stage 0,1]
                                         [--reps 100] [--parent DIR] [--record out.json]

First records full-pool batches of the engines that launch these kernels,
as chip_smoke.py drives them (1 spp): for the dense set, the dense fused
engine on the RTiOW final scene (1200x675 depth 50, chip_smoke.py's phase
19), whose middle batch K10 bounces and K11 intersects, and chip_smoke.py's
16,384 random rays over bench.py's 8,192-sphere field (phase 25) for K11;
for the culled set, K14 in the culled fused engine (tiled) on the field
(1024x576 depth 8, chunks of 128) and on the final scene, K13 in the
reference wavefront engine over the culled field, each run's middle
batch.  Then builds the sources once for each shape into
build/group_probe/ (all nvcc started together; the package's own
libraries, under build/kernels/, keep their one shape each): the dense set
for each (G, threads) with -DDR_DENSE_GROUP and -DDR_DENSE_THREADS (G in
4, 8, 16, 32 by default), with scripts/group_probe_dense.cu beside it,
which holds the arm of each dense kernel that the package does not launch
up to 512 spheres (K10 reading the sweep columns from global memory, K11
staging them in shared memory), so that each runs staged (1) and not (0)
on the final scene (the field's 8,193 spheres fit no block: there K10
and K11 read global memory); the culled set for each (G, threads) with
-DDR_GROUP and -DDR_GROUP_THREADS (G in 8, 16, 32).  Prints each kernel's
registers and spills (-Xptxas -v), holds
each variant bit for bit against the plain versions on the batches,
counters included, and times it by CUDA events (chip_smoke.kernel_ms: the
mean of --reps launches queued behind a sleep, so that the card runs them
back to back; beside it chip_smoke.cuda_ms, the same launches queued as the
host makes them; every variant twice, the second pass in reverse order),
and prints each kernel's variants by their mean time.  The culled set also
reports its group lane use (slot tests / slot-test lanes issued) and the
rate at which its groups read the sweep columns, and times K13 on the
field batch with the sweep columns staged in shared memory by persistent
blocks (scripts/group_probe_staged.cu, G = 32, 1,024 threads a block)
beside the same G in the package's kernel.  With --parent DIR (a checkout
of an earlier tree whose launchers take the same arguments), builds DIR's
sources as they are and times parent, change, change, parent on the same
batches (the change is the package's own build), each held bit for bit
against the plain versions.  Exits with code 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, kernel_ms, ptxas_kernels, walk_camera  # noqa: E402

SETS = {  # each set's sources, the -D names of its shape, and its default groups
    "dense": (("fused_bounce", "intersect"), ("DR_DENSE_GROUP", "DR_DENSE_THREADS"), "4,8,16,32"),
    "culled": (("fused_bounce", "culled_intersect"), ("DR_GROUP", "DR_GROUP_THREADS"), "8,16,32"),
}
# each kernel's source and its entry function in the ptxas report
# (kernel, staged): its source and its entry function in the ptxas report
KERNEL_OF = {("K10", 1): ("fused_bounce", "fused_bounce_kernel<true>"),
             ("K10", 0): ("fused_bounce", "fused_bounce_kernel<false>"),
             ("K11", 0): ("intersect", "closest_hit_kernel"),
             ("K11", 1): ("group_probe_dense", "staged_closest_hit_kernel"),
             ("K14", 0): ("fused_bounce", "culled_fused_bounce_kernel"),
             ("K13", 0): ("culled_intersect", "culled_closest_hit_kernel<true>")}
PROBE_DIR = ROOT / "build" / "group_probe"
STAGED = ROOT / "scripts" / "group_probe_staged.cu"
DENSE_ARMS = ROOT / "scripts" / "group_probe_dense.cu"
FIELD_RAYS = 16384  # chip_smoke.py phase 25's random rays over the field


def build_variants(shapes, parent, staged_k13: bool) -> dict:
    """{(set, g, threads): {source: (library path, ptxas entries)}} (the
    dense set also builds group_probe_dense.cu), the staged K13's under
    "staged" and, given a parent checkout, its sources' under ("parent",
    source); every nvcc started together; raises if one fails."""
    from distributed_raytracer_tpu_torch.ops.kernels import _build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for key in shapes:
        kind, g, t = key
        srcs, (d_group, d_threads), _ = SETS[kind]
        flags = [f"-D{d_group}={g}", f"-D{d_threads}={t}"]
        jobs += [(key, src, _build.CSRC / f"{src}.cu", flags) for src in srcs]
        if kind == "dense":
            jobs.append((key, "group_probe_dense", DENSE_ARMS, flags))
    if staged_k13:
        jobs.append(("staged", "staged", STAGED, ["-DDR_GROUP=32", "-DDR_GROUP_THREADS=1024"]))
    if parent:
        srcs = sorted({s for kind in {k[0] for k in shapes} for s in SETS[kind][0]})
        jobs += [(("parent", src), src, Path(parent) / "distributed_raytracer_tpu_torch" / "csrc"
                  / f"{src}.cu", []) for src in srcs]
    procs = []
    for key, src, path, flags in jobs:
        tag = "-".join(str(x) for x in (key if isinstance(key, tuple) else (key,)))
        out = PROBE_DIR / f"lib{src}-{tag}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(path)]
        procs.append((key, src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), out))
    built = {}
    for key, src, p, out in procs:
        report = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}.cu ({key}):\n{report}")
        if key == "staged" or key[0] == "parent":
            built[key] = (out, ptxas_kernels(report))
        else:
            built.setdefault(key, {})[src] = (out, ptxas_kernels(report))
    return built


class Renamed:
    """A loaded library whose entries named in `names` are other entries
    of it, so that a wrapper of the package launches a probe variant."""

    def __init__(self, lib, **names):
        self._lib, self._names = lib, names

    def __getattr__(self, name):
        return getattr(self._lib, self._names.get(name, name))


_opened = {}


def opened(path):
    """The library at path, loaded once."""
    if path not in _opened:
        _opened[path] = ctypes.CDLL(str(path))
    return _opened[path]


def use_libraries(libs: dict) -> None:
    """Make the package's wrappers launch these libraries ({source: path
    or loaded library}); an empty dict restores the package's own
    build."""
    from distributed_raytracer_tpu_torch.ops.kernels import _build

    for src in ("fused_bounce", "intersect", "culled_intersect"):
        _build._loaded.pop(src, None)
    for src, lib in libs.items():
        _build._loaded[src] = opened(lib) if isinstance(lib, Path) else lib


def dense_libraries(libs: dict, staged: int) -> dict:
    """The dense variant's {source: library}: the package's two sources
    as built, with K10 (staged 0) or K11 (staged 1) taken from the probe
    arms' library instead (which reports the same -D shape through its own
    copy of fused_bounce_shape)."""
    arms = opened(libs["group_probe_dense"][0])
    out = {src: opened(libs[src][0]) for src in SETS["dense"][0]}
    if staged:
        out["intersect"] = Renamed(arms, closest_hit_launch="staged_closest_hit_launch",
                                   closest_hit_shape="fused_bounce_shape")
    else:
        out["fused_bounce"] = Renamed(arms, fused_bounce_launch="unstaged_fused_bounce_launch")
    return out


def same(got, want) -> bool:
    return all(torch.equal(x, y) for x, y in zip(got, want))


def dense_runs(dev, presets):
    """[(kernel, batch label, launch(**kw), (the plain version's outputs,
    its counters), the number of counters)]: K10 on the dense fused
    engine's middle pool batch of the final scene, K11 on its rays and on
    the field's random rays."""
    from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
    from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
    from distributed_raytracer_tpu_torch.render import wavefront
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    final = presets.rtiow_final_scene(seed=0, pad_to=512)
    real, kept = wavefront.fused_bounce, []

    def keep(o, d, live, lane_ray, scene, seed, **kw):
        kept.append((o, d, live, lane_ray, seed))
        return real(o, d, live, lane_ray, scene, seed, **kw)

    wavefront.fused_bounce = keep
    try:
        render_progressive(final, presets.final_scene_camera(1200), seed=0, spp=1, batch=1,
                           engine="fused")
    finally:
        wavefront.fused_bounce = real
    o, d, live, lane_ray, seed = kept[len(kept) // 2]
    fd = final.to(dev)
    arrays = bk.fused_scene_arrays(fd)
    sph_f = ik.sphere_pack(fd.centers, fd.radii)
    field = presets.random_sphere_field(8192, seed=5, extent=30.0).to(dev)
    sph_w = ik.sphere_pack(field.centers, field.radii)
    g = torch.Generator().manual_seed(11)  # chip_smoke.py phase 25's rays
    o_r = ((torch.rand(FIELD_RAYS, 3, generator=g) * 2.0 - 1.0) * 40.0).to(dev)
    d_r = torch.randn(FIELD_RAYS, 3, generator=g).to(dev)

    def k10(**kw):
        return bk.fused_bounce_cuda(o, d, live, lane_ray, arrays, seed, **kw)

    st = torch.zeros(4, dtype=torch.int64, device=dev)
    want10 = (bk.fused_bounce_plain(o, d, live, lane_ray, arrays, seed, stats=st), st)
    runs = [("K10", "final, dense engine's middle pool batch", k10, want10, 4)]
    for label, ro, rd, sph in (("final, the same batch's rays", o, d, sph_f),
                               ("field, 16,384 random rays", o_r, d_r, sph_w)):
        st = torch.zeros(1, dtype=torch.int64, device=dev)
        want = (ik.closest_hit_plain(ro, rd, sph, stats=st), st)
        runs.append(("K11", label, lambda ro=ro, rd=rd, sph=sph, **kw: ik.closest_hit_cuda(
            ro, rd, sph, **kw), want, 1))
    torch.cuda.synchronize()
    return runs


def culled_runs(dev, presets):
    """The culled set's runs (dense_runs' form), and K13's operands for the
    staged variant: K14 on the culled fused engine's middle pool batches
    of the field and the final scene, K13 on the reference wavefront
    engine's middle batch over the culled field."""
    from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
    from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
    from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
    from distributed_raytracer_tpu_torch.render import wavefront
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    real = wavefront.culled_fused_bounce

    def k14_batch(scene, cam, culled):
        kept = []

        def keep(o, d, live, lane_ray, pack, seed, **kw):
            kept.append((o, d, live, lane_ray, seed))
            return real(o, d, live, lane_ray, pack, seed, **kw)

        wavefront.culled_fused_bounce = keep
        try:
            render_progressive(culled.scene, cam, seed=0, spp=1, batch=1, engine="fused",
                               culled=culled, ray_order="tiled")
        finally:
            wavefront.culled_fused_bounce = real
        return kept[len(kept) // 2]

    field = presets.random_sphere_field(8192, seed=5, extent=30.0)
    final = presets.rtiow_final_scene(seed=0, pad_to=512)
    culled_w = ck.build_culled_scene(field, chunk=128)
    culled_f = ck.build_culled_scene(final, chunk=128)
    runs = []
    for name, scene, cam, culled in (
            ("field", field, walk_camera(presets, 1024), culled_w),
            ("final", final, presets.final_scene_camera(1200), culled_f)):
        b = k14_batch(scene, cam, culled)
        pack = cb.build_culled_pack(culled).to(dev)
        st = torch.zeros(4, dtype=torch.int64, device=dev)
        want = (cb.culled_fused_bounce_plain(*b[:4], pack, b[4], stats=st), st)
        runs.append(("K14", f"{name}, culled engine's middle pool batch",
                     lambda b=b, pack=pack, **kw: cb.culled_fused_bounce_cuda(*b[:4], pack, b[4],
                                                                              **kw), want, 4))
    rays = []
    fn = ck.make_culled_intersect(culled_w, mode="walk")

    def keep_rays(ray_o, ray_d, scene):
        rays.append((ray_o, ray_d))
        return fn(ray_o, ray_d, scene)

    render_progressive(culled_w.scene, walk_camera(presets, 1024), seed=0, spp=1, batch=1,
                       engine="wavefront", intersect_fn=keep_rays, ray_order="tiled")
    o13, d13 = rays[len(rays) // 2]
    csc = culled_w.scene.to(dev)
    sph = ik.sphere_pack(csc.centers, csc.radii)
    br, nb = ck.plan_blocks(o13.shape[0])
    order, n_visit = ck.block_visit_plan(o13, d13, torch.from_numpy(culled_w.bounds_c).to(dev),
                                         torch.from_numpy(culled_w.bounds_r2).to(dev), nb, br)
    k13_args = (o13, d13, sph, ck.culled_bounds(culled_w, dev), order, n_visit, culled_w.chunk,
                br)
    # the plain version has no counters; the kernel's are checked on the card tests
    want13 = (ck.culled_closest_hit_plain(o13, d13, sph, order, culled_w.chunk, br), None)
    runs.append(("K13", "field, wavefront engine's middle batch",
                 lambda **kw: ck.culled_closest_hit_walk_cuda(*k13_args, **kw), want13, 5))
    torch.cuda.synchronize()
    return runs, k13_args


def check_run(run, dev, issued=None):
    """Launch a run once with counters; raise unless it equals plain."""
    kernel, label, launch, (want, want_st), n_stats = run
    stats = torch.zeros(n_stats, dtype=torch.int64, device=dev)
    kw = dict(stats=stats) if issued is None else dict(stats=stats, issued=issued)
    got = launch(**kw)
    if not same(got, want) or (want_st is not None and not torch.equal(stats, want_st)):
        raise SystemExit(f"{kernel} ({label}) differs from its plain version")
    return stats


def staged_k13(lib_path, k13_args, want13, built, rows, reps, dev):
    """K13 with the sweep columns staged in shared memory by persistent
    blocks, beside the package's kernel at G = 32."""
    from distributed_raytracer_tpu_torch.ops.kernels import _build
    from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck

    lib = ctypes.CDLL(str(lib_path))
    lib.staged_walk_grid.argtypes = [ctypes.c_int]
    lib.staged_walk_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int] + [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                                       + [ctypes.c_int, ctypes.c_void_p])
    o_, d_, sph_, bounds_, order_, n_visit_, chunk_, br_ = k13_args
    n_slots = sph_.shape[0]
    grid = lib.staged_walk_grid(n_slots)
    if grid < 1:
        raise SystemExit(f"staged K13: no grid (CUDA error {-grid})")
    t_s = torch.empty(o_.shape[0], dtype=torch.float32, device=dev)
    i_s = torch.empty(o_.shape[0], dtype=torch.int32, device=dev)

    def staged():
        err = lib.staged_walk_launch(o_.data_ptr(), d_.data_ptr(), o_.shape[0], sph_.data_ptr(),
                                     n_slots, bounds_.data_ptr(), order_.data_ptr(),
                                     n_visit_.data_ptr(), order_.shape[1], chunk_, br_,
                                     t_s.data_ptr(), i_s.data_ptr(), grid,
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(err, "staged_walk_launch")

    staged()
    torch.cuda.synchronize()
    if not (torch.equal(t_s, want13[0]) and torch.equal(i_s, want13[1])):
        raise SystemExit("staged K13 differs from its plain version")
    for (kind, g, t), libs in built.items():
        if kind != "culled" or g != 32:
            continue
        use_libraries({src: path for src, (path, _) in libs.items()})
        for label, fn in ((f"package, G=32, {t} threads", lambda: ck.culled_closest_hit_walk_cuda(
                *k13_args)), (f"staged in shared memory, G=32, 1024 threads, grid {grid}",
                              staged)) * 2:
            ms = kernel_ms(fn, reps)
            rows.append(dict(kernel="K13", variant=label, ms=ms))
            print(f"[staged] K13 field, {label}: {ms:.4f} ms per launch (equal to plain)",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="dense,culled", help="the sets to probe: dense, culled")
    ap.add_argument("--groups", default=None, help="lanes per ray (default: the set's own)")
    ap.add_argument("--threads", default="128,256,512")
    ap.add_argument("--stage", default="0,1", help="the dense set's staging, 0 and/or 1")
    ap.add_argument("--reps", type=int, default=100, help="launches timed per variant")
    ap.add_argument("--parent", default=None, help="a checkout of an earlier tree")
    ap.add_argument("--record", default=None, help="write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_group_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
    from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
    from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
    from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")
    kinds = args.kernels.split(",")
    shapes = [(kind, int(g), int(t)) for kind in kinds
              for g in (args.groups or SETS[kind][2]).split(",") for t in args.threads.split(",")]
    built = build_variants(shapes, args.parent, "culled" in kinds)
    staged_lib = built.pop("staged", (None,))[0]
    parent_libs = {key[1]: built.pop(key)[0] for key in list(built) if key[0] == "parent"}
    for (kind, g, t), libs in built.items():
        for src, (_, entries) in libs.items():
            for e in entries:
                print(f"[build] {kind} G={g} threads={t} {src}.cu {e['kernel']}: "
                      f"{e['registers']} registers, spill stores {e['spill_stores']} B, loads "
                      f"{e['spill_loads']} B, {e['smem']} B smem", flush=True)
    # a variant: a shape and, for the dense set, staged 0 or 1
    variants = [(kind, g, t, int(s)) for kind, g, t in built
                for s in (args.stage.split(",") if kind == "dense" else ["0"])]

    runs = {"dense": dense_runs(dev, presets)} if "dense" in kinds else {}
    if "culled" in kinds:
        runs["culled"], k13_args = culled_runs(dev, presets)
    shape_of = {"K10": bk.group_shape, "K11": ik.group_shape, "K14": cb.group_shape,
                "K13": ck.group_shape}

    rows = []
    passes = variants + variants[::-1]
    for n_pass, key in enumerate(passes):
        kind, g, t, s = key
        libs = built[(kind, g, t)]
        use_libraries(dense_libraries(libs, s) if kind == "dense"
                      else {src: path for src, (path, _) in libs.items()})
        for run in runs[kind]:
            name, label, launch = run[:3]
            if kind == "dense" and "field" in label and s != 0:
                continue  # staging applies up to 512 spheres
            shape = shape_of[name]()
            assert tuple(shape) == (g, t), (name, shape, key)
            issued = torch.zeros(1, dtype=torch.int64, device=dev) if kind == "culled" else None
            stats = check_run(run, dev, issued)
            ms = kernel_ms(launch, args.reps)
            unheld = cuda_ms(launch, args.reps)
            src, entry = KERNEL_OF[(name, s)]
            regs = [e for e in libs[src][1] if e["kernel"] == entry]
            row = dict(kernel=name, batch=label, set=kind, group=g, threads=t, staged=s,
                       pass_=n_pass // len(variants), ms=ms, ms_unheld=unheld,
                       registers=[e["registers"] for e in regs],
                       spill_stores=[e["spill_stores"] for e in regs])
            extra = ""
            if kind == "culled":
                tests = int(stats[len(stats) - 2])
                use = mk.group_lane_use(tests, int(issued))
                row.update(tests=tests, issued=int(issued), group_lane_use=use,
                           sweep_read_gb_per_s=tests * 16 / ms / 1e6)
                extra = (f", group lane use {use:.4f}, sweep reads "
                         f"{tests * 16 / ms / 1e6:.1f} GB/s")
            rows.append(row)
            print(f"[group] {name} {label}: G={g}, {t} threads"
                  f"{f', staged {s}' if kind == 'dense' else ''} (pass "
                  f"{n_pass // len(variants) + 1}): {ms:.4f} ms per launch ({unheld:.4f} as the host "
                  f"queues them), equal to plain{extra}", flush=True)

    for name, label in sorted({(r["kernel"], r["batch"]) for r in rows}):
        means = {}
        for r in rows:
            if (r["kernel"], r["batch"]) == (name, label):
                means.setdefault((r["group"], r["threads"], r["staged"]), []).append(r["ms"])
        order = sorted(means, key=lambda k: sum(means[k]) / len(means[k]))
        print(f"[best] {name} {label}: " + ", ".join(
            f"G={g} x {t}{f' staged {s}' if name in ('K10', 'K11') else ''} "
            f"{sum(means[(g, t, s)]) / len(means[(g, t, s)]):.4f}" for g, t, s in order),
            flush=True)

    if staged_lib is not None:
        staged_k13(staged_lib, k13_args, runs["culled"][-1][3][0], built, rows, args.reps, dev)

    if args.parent:  # parent, change, change, parent on the same batches
        parent = parent_libs
        use_libraries({})
        print(f"[compare] the change's shapes: K10 {bk.group_shape()}, K11 {ik.group_shape()}, "
              f"K14 {cb.group_shape()}, K12/K13 {ck.group_shape()}", flush=True)
        for kind in kinds:
            for run in runs[kind]:
                name, label, launch = run[:3]
                times = []
                for side in ("parent", "change", "change", "parent"):
                    use_libraries(parent if side == "parent" else {})
                    check_run(run, dev)
                    times.append((side, kernel_ms(launch, args.reps)))
                rows.append(dict(kernel=name, batch=label, compare=times))
                print(f"[compare] {name} {label}: " + ", ".join(
                    f"{side} {ms:.4f}" for side, ms in times) + " ms per launch (each equal to "
                    "plain, counters included)", flush=True)
        use_libraries({})
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
