"""Command-line interface of the port.

    python -m distributed_raytracer_tpu_torch.cli render --config config5 --spp 4 --out out.ppm

`render` is the progressive renderer, with checkpoint/resume, on the mega
engine (the default), the fused wavefront engine (--engine fused), the
reference wavefront engine (--engine wavefront; --pallas intersects with
the K11 kernel) or the scan engine (--engine scan); --accel culled
renders over the Morton-chunked CulledScene (chunks of 256 on the mega
engine, 128 on the wavefront engines, whose rays then stream in tiles
and may be re-sorted with --resort K; the reference wavefront engine
intersects it with the block-culled K12).  It runs on the CUDA card;
--cpu runs the plain PyTorch versions on the CPU instead.

    python -m distributed_raytracer_tpu_torch.cli render --engine fused --accel culled --cpu
    python -m distributed_raytracer_tpu_torch.cli render --engine wavefront --pallas --cpu

`grad-check` prints the loss and dL/dscene of a 4-sample render against
the render of another key; `invert` recovers a perturbed albedo by Adam
steps on the scan engine (JAX's cli.py:533-582), --steps of them:

    python -m distributed_raytracer_tpu_torch.cli grad-check --config config1 --width 64
    python -m distributed_raytracer_tpu_torch.cli invert --config config1 --width 64 --steps 3

Every command takes --scene FILE (a models/scene_io.py file; `export-scene`
writes one from a preset):

    python -m distributed_raytracer_tpu_torch.cli export-scene --config config5 scene.json
    python -m distributed_raytracer_tpu_torch.cli render --scene scene.json --spp 4

`render-dist` renders over the ranks of a job, each rank its shard of the
pixels (the mega engine on the card, scan with --cpu; --scene-shards K
also splits the spheres over K ranks of a row).  Every process runs the
same command; rank 0 writes the image:

    python -m distributed_raytracer_tpu_torch.cli render-dist --config config5 --spp 4 \
        --coordinator localhost:29500 --num-processes 1 --process-id 0
"""

from __future__ import annotations

import argparse
import sys
import time


def _load(args):
    from distributed_raytracer_tpu_torch.models.presets import get_config
    from distributed_raytracer_tpu_torch.ops.camera import make_camera

    if getattr(args, "scene", None):
        from distributed_raytracer_tpu_torch.models.scene_io import load_scene

        scene, file_cam = load_scene(args.scene)
        # the file's camera if it has one, else the preset's; --width and
        # --spp apply after, either way
        cam = file_cam if file_cam is not None else get_config(args.config)[1]
    else:
        scene, cam = get_config(args.config)
    if args.width:
        cam = make_camera(
            aspect_ratio=cam.image_width / cam.image_height,
            image_width=args.width,
            samples_per_pixel=cam.samples_per_pixel,
            max_depth=cam.max_depth,
            vfov=float(cam.vfov),
            lookfrom=tuple(float(x) for x in cam.lookfrom),
            lookat=tuple(float(x) for x in cam.lookat),
            vup=tuple(float(x) for x in cam.vup),
            defocus_angle=float(cam.defocus_angle),
            focus_dist=float(cam.focus_dist),
        )
    if args.spp:
        cam = cam.replace(samples_per_pixel=args.spp)
    return scene, cam


def cmd_render(args):
    from distributed_raytracer_tpu_torch.render.image import write_ppm
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive

    scene, cam = _load(args)
    out = args.out or f"{args.config}.ppm"
    device = "cpu" if args.cpu else None
    culled = intersect_fn = None
    if args.accel == "culled":
        from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import (
            build_culled_scene,
            make_culled_intersect,
        )

        culled = build_culled_scene(scene, chunk=256 if args.engine == "mega" else 128)
        scene = culled.scene  # the reordered scene the culled engines trace
        if args.engine in ("scan", "wavefront"):
            # the reference engine intersects the culled scene through K12;
            # the mega and fused engines walk the CulledScene themselves
            intersect_fn, culled = make_culled_intersect(culled), None
            args.engine = "wavefront"
    t0 = time.time()

    def progress(state):
        el = time.time() - t0
        print(
            f"sample {state.samples_done}/{cam.samples_per_pixel} "
            f"({cam.num_pixels * state.samples_done / el:,.0f} rays/s) [{args.engine}]",
            file=sys.stderr,
        )

    state = render_progressive(
        scene, cam, seed=args.seed, spp=cam.samples_per_pixel, batch=args.batch,
        checkpoint_path=args.checkpoint, resume=not args.no_resume,
        progress_cb=progress, engine=args.engine, device=device, culled=culled,
        ray_order="tiled" if args.accel == "culled" else "row", resort_every=args.resort,
        use_pallas=args.pallas, intersect_fn=intersect_fn,
    )
    write_ppm(out, state.mean_image())
    print(f"wrote {out} [engine={state.engine}, device={'cpu' if args.cpu else 'cuda'}]",
          file=sys.stderr)


def cmd_grad_check(args):
    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.grad.diff_render import render_diff, scene_grads

    scene, cam = _load(args)
    dev = _device(args)
    s = range(4)
    with torch.no_grad():
        target = render_diff(scene.to(dev), cam.to(dev), prng.PRNGKey(args.seed + 1), s)
    loss, grads = scene_grads(scene, cam, prng.PRNGKey(args.seed), s, target, device=dev)
    print(f"loss: {float(loss):.6f}", file=sys.stderr)
    for k, g in grads.items():
        g = g.cpu().numpy()
        print(f"  d/d{k}: |g|={np.abs(g).max():.3e} finite={np.all(np.isfinite(g))}",
              file=sys.stderr)


def cmd_invert(args):
    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.grad.diff_render import InverseRenderer, render_diff

    scene, cam = _load(args)
    dev = _device(args)
    cam = cam.replace(samples_per_pixel=4)
    with torch.no_grad():
        target = render_diff(scene.to(dev), cam.to(dev), prng.PRNGKey(123), range(8))
    rng = np.random.default_rng(args.seed)
    noise = torch.as_tensor(rng.normal(0, 0.2, tuple(scene.albedo.shape)), dtype=torch.float32)
    start = scene.with_diff_params({"albedo": torch.clamp(scene.albedo + noise, 0.05, 0.95)})
    inv = InverseRenderer(start, cam, target, fields=("albedo",), learning_rate=2e-2,
                          device=dev)
    for i in range(args.steps):
        loss = inv.step()
        if i % 10 == 0:
            print(f"step {i}: loss {loss:.6f}", file=sys.stderr)
    err = float((inv.scene.albedo.cpu() - scene.albedo).abs().mean())
    print(f"final albedo MAE: {err:.4f}", file=sys.stderr)


def cmd_render_dist(args):
    # every rank runs this same command; rank 0 writes the one image
    import torch

    from distributed_raytracer_tpu_torch.core import prng
    from distributed_raytracer_tpu_torch.parallel import (
        ShardedRenderer,
        make_mega_dp_render,
        make_mega_walk_dp_render,
        make_mesh,
        make_fused_dp_render,
        make_scene_sharded_render,
        shard_scene,
    )
    from distributed_raytracer_tpu_torch.parallel import multihost
    from distributed_raytracer_tpu_torch.parallel.mesh import pad_to_multiple
    from distributed_raytracer_tpu_torch.render.image import write_ppm

    t_start = time.time()
    dev = _device(args)
    multihost.initialize(args.coordinator, args.num_processes, args.process_id, device=dev)
    try:
        info = multihost.process_info()
        p0 = info["process_index"] == 0
        scene, cam = _load(args)
        scene = multihost.replicate_scene(scene.to(dev))
        mesh = make_mesh(n_scene=args.scene_shards)
        spp = cam.samples_per_pixel
        n = cam.num_pixels
        key = prng.PRNGKey(args.seed)
        engine = args.engine
        if engine == "auto":
            engine = "scan" if args.cpu else "mega"
        if engine != "scan" and args.scene_shards > 1:
            print(f"[render-dist] --scene-shards > 1 runs the 2D scan path; --engine {engine} "
                  "ignored", file=sys.stderr)
            engine = "scan"
        acc = None
        t0 = time.time()
        if engine == "mega":
            from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import (
                mega_render_supported,
            )

            # JAX's seeds of PRNGKey(seed), and batches of absolute sample
            # indices accumulated in sample order: the same image bits
            # whatever the world size and the batch split
            bs, cs = prng.seed_pair(key)
            if mega_render_supported(scene):
                dp = make_mega_dp_render(mesh, cam, device=dev)

                def render(s, acc):
                    return dp(scene, bs, cs, s, acc=acc)
            else:  # past 512 spheres: the walk (K9), as render_progressive routes it
                from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_kernel import (
                    walk_pack_for,
                )

                engine = "mega (walk)"
                dp = make_mega_walk_dp_render(mesh, walk_pack_for(scene.to("cpu"), cam, 256),
                                              cam, device=dev)

                def render(s, acc):
                    return dp(bs, cs, s, acc=acc)
        elif engine == "fused":
            dp = make_fused_dp_render(mesh, cam, device=dev)

            def render(s, acc):
                part = dp(scene, prng.fold_in(key, s[0]), len(s))
                return part if acc is None else acc + part
        elif args.scene_shards > 1:
            padded = shard_scene(scene, args.scene_shards)
            m = pad_to_multiple(n, mesh.n_rays)
            ids = torch.zeros(m, dtype=torch.int64, device=dev)
            ids[:n] = torch.arange(n, device=dev)
            sharded = make_scene_sharded_render(mesh, cam, device=dev)

            def render(s, acc):
                part = sharded(padded, key, s, ids)
                return part if acc is None else acc + part
        else:
            renderer = ShardedRenderer(mesh, cam, device=dev)

            def render(s, acc):
                part = renderer.render_sample_sum_padded(scene, key, s)
                return part if acc is None else acc + part
        done = 0
        while done < spp:
            nb = min(args.batch, spp - done)
            acc = render(list(range(done, done + nb)), acc)
            done += nb
            if p0:  # the samples are queued, not finished: no rate until the gather
                print(f"samples {done}/{spp} [{engine}]", file=sys.stderr)
        img = (multihost.gather_image(acc, mesh)[:n].cpu().numpy() / spp).reshape(
            cam.image_height, cam.image_width, 3)
        t1 = time.time()
        out = args.out or f"{args.config}_dist.ppm"
        if p0:
            write_ppm(out, img)
            print(f"wrote {out} (mesh {mesh.shape}, engine {engine}, "
                  f"{info['process_count']} process(es), {info['backend'] or 'no'} backend; "
                  f"{(t1 - t0) * 1e3 / spp:.2f} ms/sample after {(t0 - t_start) * 1e3:.0f} ms "
                  "of set-up)", file=sys.stderr)
    finally:
        multihost.shutdown()


def cmd_export_scene(args):
    from distributed_raytracer_tpu_torch.models.presets import get_config
    from distributed_raytracer_tpu_torch.models.scene_io import save_scene

    scene, cam = get_config(args.config)
    save_scene(args.out, scene, None if args.no_camera else cam)
    print(f"wrote {args.out} ({scene.num_spheres} spheres)", file=sys.stderr)


def _device(args):
    from distributed_raytracer_tpu_torch.core.device import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def _add_common(p):
    p.add_argument("--config", default="config1", help="preset name (config1..config5)")
    p.add_argument("--scene", default=None, metavar="FILE",
                   help="scene file (.json or .npz, models/scene_io.py); overrides the "
                        "preset's scene, and its camera too when the file has one")
    p.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=16, help="samples per batch")
    p.add_argument("--out", default=None, help="output .ppm path")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch version on the CPU")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="distributed_raytracer_tpu_torch", allow_abbrev=False)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="single-device progressive render", allow_abbrev=False)
    _add_common(p)
    p.add_argument("--checkpoint", default=None, help="checkpoint path for resume")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--engine", choices=["mega", "fused", "scan", "wavefront"], default="mega",
                   help="mega = one kernel launch per image sample; fused = the wavefront "
                        "engine, one fused bounce launch per bounce of a ray pool; scan = "
                        "the reference bounce over ray tiles; wavefront = the reference "
                        "bounce over a ray pool (JAX's threefry noise)")
    p.add_argument("--pallas", action="store_true",
                   help="the wavefront engine intersects with the closest-hit kernel (K11)")
    p.add_argument("--accel", choices=["none", "culled"], default="none",
                   help="culled = render over Morton chunks with bounding spheres, each "
                        "ray sweeping only the chunks it can still hit")
    p.add_argument("--resort", type=int, default=0, metavar="K",
                   help="re-sort the wavefront engines' lanes every K bounces (--accel "
                        "culled; 0 = off)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser(
        "render-dist", allow_abbrev=False,
        help="render sharded over the ranks of a job (run the same command in every "
             "process; rank 0 writes the image)")
    _add_common(p)
    p.add_argument("--engine", choices=["auto", "scan", "fused", "mega"], default="auto",
                   help="each rank's engine on its pixel shard: mega = one kernel launch per "
                        "sample (the walk past 512 spheres; the image is the single-device "
                        "one bit for bit); fused = the fused wavefront engine; scan = the "
                        "reference bounce.  auto = mega on the card, scan with --cpu")
    p.add_argument("--scene-shards", type=int, default=1,
                   help="shard the sphere axis over this many ranks (the 2D scan path)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's rendezvous address, or an init URL (tcp://..., file://...); "
                        "default MASTER_ADDR:MASTER_PORT; omit for one process")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the job (default WORLD_SIZE)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (default RANK)")
    p.set_defaults(fn=cmd_render_dist)

    p = sub.add_parser("export-scene", allow_abbrev=False,
                       help="write a preset's scene (and camera) to a .json or .npz scene "
                            "file, for render --scene")
    p.add_argument("--config", default="config4", help="preset to export (config1..config5)")
    p.add_argument("--no-camera", action="store_true", help="leave the camera out")
    p.add_argument("out", help="output path (.json or .npz)")
    p.set_defaults(fn=cmd_export_scene)

    p = sub.add_parser("grad-check", help="dL/dscene sanity check", allow_abbrev=False)
    _add_common(p)
    p.set_defaults(fn=cmd_grad_check)

    p = sub.add_parser("invert", help="inverse-rendering demo", allow_abbrev=False)
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.set_defaults(fn=cmd_invert)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
