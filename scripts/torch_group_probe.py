"""The group walk of the culled kernels (csrc/trace.cuh group_walk: K14 in
csrc/fused_bounce.cu, K12/K13 in csrc/culled_intersect.cu) at several
lanes per ray (G) and block sizes, on one CUDA card.

    python3 scripts/torch_group_probe.py [--groups 8,16,32] [--threads 128,256,512]
                                         [--record out.json]

First records full-pool batches of the engines that launch these kernels,
as chip_smoke.py drives them (tiled ray order, 1 spp): K14 in the culled
fused engine on bench.py's 8,192-sphere field (1024x576 depth 8, chunks of
128) and on the RTiOW final scene (1200x675 depth 50), K13 in the
reference wavefront engine over the culled field; each run's middle batch
is kept.  Then builds both sources once for each (G, threads) with
-DDR_GROUP and -DDR_GROUP_THREADS into build/group_probe/ (all nvcc
started together; the package's own library, under build/kernels/, keeps
its one shape), prints each kernel's registers and spills (-Xptxas -v),
holds each variant bit for bit against the plain versions on those
batches, and times it by CUDA events (chip_smoke.kernel_ms: the mean of
--reps launches queued behind a sleep, so that the card runs them back to
back; beside it chip_smoke.cuda_ms, the same launches queued as the host
makes them; every variant twice, the second pass in reverse order), with its
group lane use (slot tests / slot-test lanes issued) and the rate at which
its groups read the sweep columns (16 B a slot test: a group reads an
admitted chunk's slots once for its ray).  Last, K13 on the field batch
with the sweep columns staged in shared memory by persistent blocks
(scripts/group_probe_staged.cu, G = 32, 1,024 threads a block), beside
the same G in the package's kernel: if the reads set the pace, the staged
variant is faster.  With --parent DIR (a checkout of the tree before the
group walk), builds DIR's two sources as they are (one thread per ray)
and times parent, change, change, parent on the same batches (K14 on both
scenes, K12 and K13 on the field; the change is the package's own build),
each held bit for bit against the plain versions.  Exits with code 2
without a CUDA card.
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

BOUNCE_SEED = 123456
SOURCES = ("fused_bounce", "culled_intersect")
PROBE_DIR = ROOT / "build" / "group_probe"
STAGED = ROOT / "scripts" / "group_probe_staged.cu"


def build_variants(shapes, parent) -> dict:
    """{(g, threads): {source: (library path, ptxas entries)}}, the staged
    K13's under "staged" and, given a parent checkout, its sources' under
    ("parent", source); every nvcc started together; raises if one fails."""
    from distributed_raytracer_tpu_torch.ops.kernels import _build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(g, t, src, _build.CSRC / f"{src}.cu") for g, t in shapes for src in SOURCES]
    jobs.append((32, 1024, "staged", STAGED))
    if parent:
        jobs += [(0, 0, f"parent-{src}", Path(parent) / "distributed_raytracer_tpu_torch" / "csrc"
                  / f"{src}.cu") for src in SOURCES]
    procs = {}
    for g, t, src, path in jobs:
        out = PROBE_DIR / f"lib{src}-G{g}-T{t}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DDR_GROUP={g}", f"-DDR_GROUP_THREADS={t}",
               "-o", str(out), str(path)]
        procs[(g, t, src)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for (g, t, src), (p, out) in procs.items():
        report = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}.cu at G={g}, {t} threads:\n{report}")
        if src == "staged" or src.startswith("parent"):
            built[src] = (out, ptxas_kernels(report))
        else:
            built.setdefault((g, t), {})[src] = (out, ptxas_kernels(report))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", default="8,16,32")
    ap.add_argument("--threads", default="128,256,512")
    ap.add_argument("--reps", type=int, default=100, help="launches timed per variant")
    ap.add_argument("--parent", default=None, help="a checkout of the tree before the group walk")
    ap.add_argument("--record", default=None, help="write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_group_probe: no CUDA device available", file=sys.stderr)
        return 2
    from distributed_raytracer_tpu_torch.models import presets
    from distributed_raytracer_tpu_torch.ops.kernels import _build
    from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
    from distributed_raytracer_tpu_torch.ops.kernels import culled_kernel as ck
    from distributed_raytracer_tpu_torch.ops.kernels import intersect_kernel as ik
    from distributed_raytracer_tpu_torch.ops.kernels import mega_kernel as mk
    from distributed_raytracer_tpu_torch.render import wavefront
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")
    shapes = [(int(g), int(t)) for g in args.groups.split(",") for t in args.threads.split(",")]
    built = build_variants(shapes, args.parent)
    staged_lib = built.pop("staged")[0]
    parent_libs = {src: built.pop(f"parent-{src}") for src in SOURCES if args.parent}
    for (g, t), libs in built.items():
        for src, (_, entries) in libs.items():
            for e in entries:
                if e["kernel"].startswith("culled"):
                    print(f"[build] G={g} threads={t} {src}.cu {e['kernel']}: {e['registers']} "
                          f"registers, spill stores {e['spill_stores']} B, loads "
                          f"{e['spill_loads']} B", flush=True)

    # --- the engines' middle full-pool batches ---
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
    batches = {"K14 field": (k14_batch(field, walk_camera(presets, 1024), culled_w),
                             cb.build_culled_pack(culled_w).to(dev)),
               "K14 final": (k14_batch(final, presets.final_scene_camera(1200), culled_f),
                             cb.build_culled_pack(culled_f).to(dev))}
    rays = []

    def keep_rays(ray_o, ray_d, scene):
        rays.append((ray_o, ray_d))
        return fn(ray_o, ray_d, scene)

    fn = ck.make_culled_intersect(culled_w, mode="walk")
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
    want13 = ck.culled_closest_hit_plain(o13, d13, sph, order, culled_w.chunk, br)
    want14 = {name: cb.culled_fused_bounce_plain(*b[:4], pack, b[4])
              for name, (b, pack) in batches.items()}
    torch.cuda.synchronize()

    rows = []
    order_of_passes = list(built) + list(built)[::-1]
    for n_pass, (g, t) in enumerate(order_of_passes):
        libs = built[(g, t)]
        for src in SOURCES:
            _build._loaded[src] = ctypes.CDLL(str(libs[src][0]))
        shape = (cb.group_shape(), ck.group_shape())
        assert shape == ((g, t), (g, t)), shape
        runs = [(name, lambda b=b, pack=pack, **kw: cb.culled_fused_bounce_cuda(
                     *b[:4], pack, b[4], **kw), want14[name])
                for name, (b, pack) in batches.items()]
        runs.append(("K13 field", lambda **kw: ck.culled_closest_hit_walk_cuda(*k13_args, **kw),
                     want13))
        for name, launch, want in runs:
            n_stats = 5 if name == "K13 field" else 4
            stats = torch.zeros(n_stats, dtype=torch.int64, device=dev)
            issued = torch.zeros(1, dtype=torch.int64, device=dev)
            got = launch(stats=stats, issued=issued)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            if not same:
                raise SystemExit(f"{name} at G={g}, {t} threads differs from its plain version")
            ms = kernel_ms(launch, args.reps)
            unheld = cuda_ms(launch, args.reps)
            tests = int(stats[n_stats - 2])
            use = mk.group_lane_use(tests, int(issued))
            src = "culled_intersect" if name == "K13 field" else "fused_bounce"
            regs = [e for e in libs[src][1] if e["kernel"].startswith("culled")
                    and (src == "fused_bounce" or e["kernel"].endswith("<true>"))][0]
            rows.append(dict(kernel=name, group=g, threads=t, pass_=n_pass // len(built), ms=ms,
                             ms_unheld=unheld, tests=tests, issued=int(issued), group_lane_use=use,
                             sweep_read_gb_per_s=tests * 16 / ms / 1e6,
                             registers=regs["registers"], spill_stores=regs["spill_stores"]))
            print(f"[group] {name}: G={g}, {t} threads a block (pass {n_pass // len(built) + 1}): "
                  f"{ms:.4f} ms per launch ({unheld:.4f} as the host queues them), equal to "
                  f"plain, {tests:,} slot tests, "
                  f"{int(issued):,} lanes issued, group lane use {use:.4f}, sweep reads "
                  f"{tests * 16 / ms / 1e6:.1f} GB/s, {regs['registers']} registers", flush=True)

    # K13 with the sweep columns in shared memory, beside the package's kernel at G = 32
    lib = ctypes.CDLL(str(staged_lib))
    lib.staged_walk_grid.argtypes = [ctypes.c_int]
    lib.staged_walk_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int] + [ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                                       + [ctypes.c_int, ctypes.c_void_p])
    n_slots = sph.shape[0]
    grid = lib.staged_walk_grid(n_slots)
    if grid < 1:
        raise SystemExit(f"staged K13: no grid (CUDA error {-grid})")
    t_s = torch.empty(o13.shape[0], dtype=torch.float32, device=dev)
    i_s = torch.empty(o13.shape[0], dtype=torch.int32, device=dev)
    o_, d_, sph_, bounds_, order_, n_visit_, chunk_, br_ = k13_args

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
    for (g, t), libs in built.items():
        if g != 32:
            continue
        for src in SOURCES:
            _build._loaded[src] = ctypes.CDLL(str(libs[src][0]))
        for label, fn in ((f"package, G=32, {t} threads", lambda: ck.culled_closest_hit_walk_cuda(
                *k13_args)), (f"staged in shared memory, G=32, 1024 threads, grid {grid}",
                              staged)) * 2:
            ms = kernel_ms(fn, args.reps)
            rows.append(dict(kernel="K13 field", variant=label, ms=ms))
            print(f"[staged] K13 field, {label}: {ms:.4f} ms per launch (equal to plain)",
                  flush=True)

    if args.parent:  # parent, change, change, parent on the same batches
        from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk

        for src in SOURCES:
            _build._loaded.pop(src, None)  # the change: the package's own build
        print(f"[compare] the change's group shape {cb.group_shape()} (K14), {ck.group_shape()} "
              f"(K12/K13)", flush=True)
        lib_f = ctypes.CDLL(str(parent_libs["fused_bounce"][0]))
        lib_c = ctypes.CDLL(str(parent_libs["culled_intersect"][0]))
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        lib_f.culled_fused_bounce_launch.argtypes = [p_, p_, p_, p_, i_, i_, i_] + bk.LANE_ARGTYPES
        lib_c.culled_closest_hit_launch.argtypes = [p_, p_, i_, p_, p_, p_, p_, i_, i_, i_, i_, p_,
                                                    p_, p_, p_]

        def parent_k14(b, pack):
            o, d, live, rid, seed = b
            out = bk.empty_out(o.shape[0], dev)
            _build.check(lib_f.culled_fused_bounce_launch(
                pack.scene_pack.data_ptr(), pack.attrs.data_ptr(), pack.bounds.data_ptr(),
                pack.chunk_len.data_ptr(), pack.n_slots, pack.chunk, pack.n_chunks,
                *bk.lane_args(o, d, live, rid, None, seed, o.shape[0], out, None)), "parent K14")
            return out

        def parent_culled(walk):
            o, d, sph_c, bounds_c, order_c, n_visit_c, chunk_c, br_c = k13_args
            t_c = torch.empty(o.shape[0], dtype=torch.float32, device=dev)
            i_c = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
            _build.check(lib_c.culled_closest_hit_launch(
                o.data_ptr(), d.data_ptr(), o.shape[0], sph_c.data_ptr(), bounds_c.data_ptr(),
                order_c.data_ptr(), n_visit_c.data_ptr(), order_c.shape[1], chunk_c, br_c,
                int(walk), t_c.data_ptr(), i_c.data_ptr(), None,
                torch.cuda.current_stream().cuda_stream), "parent K12/K13")
            return t_c, i_c

        pairs = [(name, lambda b=b, pack=pack: parent_k14(b, pack),
                  lambda b=b, pack=pack: cb.culled_fused_bounce_cuda(*b[:4], pack, b[4]),
                  want14[name]) for name, (b, pack) in batches.items()]
        pairs += [(f"K1{3 if walk else 2} field", lambda walk=walk: parent_culled(walk),
                   lambda walk=walk: (ck.culled_closest_hit_walk_cuda if walk
                                      else ck.culled_closest_hit_cuda)(*k13_args), want13)
                  for walk in (False, True)]
        for name, parent_fn, change_fn, want in pairs:
            times = []
            for label, fn in (("parent", parent_fn), ("change", change_fn),
                              ("change", change_fn), ("parent", parent_fn)):
                got = fn()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise SystemExit(f"{name}: the {label} differs from the plain version")
                times.append((label, kernel_ms(fn, args.reps)))
            rows.append(dict(kernel=name, compare=times))
            print(f"[compare] {name}: " + ", ".join(f"{label} {ms:.4f}" for label, ms in times)
                  + " ms per launch (each equal to plain)", flush=True)
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
