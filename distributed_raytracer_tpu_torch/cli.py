"""Command-line interface of the port.

    python -m distributed_raytracer_tpu_torch.cli render --config config5 --spp 4 --out out.ppm

`render` is the progressive renderer, with checkpoint/resume, on the mega
engine (--engine auto, the default, picks it on the card and the scan
engine with --cpu), the fused wavefront engine (--engine fused), the
reference wavefront engine (--engine wavefront; --pallas intersects with
the K11 kernel) or the scan engine (--engine scan); --accel culled
renders over the Morton-chunked CulledScene (chunks of 256 on the mega
engine, 128 on the wavefront engines, whose rays then stream in tiles
and may be re-sorted with --resort K; the reference wavefront engine
intersects it with the block-culled K12).  It runs on the CUDA card;
--cpu runs the plain PyTorch versions on the CPU instead.

    python -m distributed_raytracer_tpu_torch.cli render --engine fused --accel culled --cpu
    python -m distributed_raytracer_tpu_torch.cli render --engine wavefront --pallas --cpu

--fill shuffled renders sample 0 in shuffled chunks of --fill-chunk
pixels first; --snapshot-every N writes the PPM every N samples (and after
each fill chunk); --display serves the image over HTTP while it renders;
--sanitize runs utils/sanitize.py's pre-flight, then renders under
nan_debug; --job FILE takes defaults from a RenderJobConfig file, and
--checkpoint PATH also writes the job's record to PATH.json.  `supervise`
restarts a render that dies or, with --heartbeat and --stall-timeout,
stalls; the restart resumes from the checkpoint (--chaos crash:N|hang:N
injects one fault):

    python -m distributed_raytracer_tpu_torch.cli supervise --stall-timeout 30 -- \
        render --config config4 --checkpoint c.ckpt --heartbeat c.beat

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


def _resolve_engine(args) -> str:
    """The engine of `render` (JAX's cli.py:80-109): auto is mega on the
    card and scan with --cpu (wavefront with --cpu and --accel culled), or
    wavefront with --wavefront; --accel culled turns the scan engine into
    the wavefront engine."""
    engine = args.engine
    if engine == "auto":
        if args.wavefront:
            return "wavefront"
        if args.cpu:
            return "wavefront" if args.accel == "culled" else "scan"
        return "mega"
    if args.accel == "culled" and engine not in ("wavefront", "fused", "mega"):
        print(f"[cli] --accel culled requires a wavefront engine; overriding --engine {engine}",
              file=sys.stderr)
        return "wavefront"
    return engine


def _job_config(args, engine):
    """The effective RenderJobConfig of this invocation, written beside the
    checkpoint as <checkpoint>.json (JAX's cli.py:112-127)."""
    from distributed_raytracer_tpu_torch.utils.config import RenderJobConfig

    return RenderJobConfig(
        preset=args.config,
        scene_path=getattr(args, "scene", None),
        seed=args.seed,
        spp=args.spp,
        batch=args.batch,
        checkpoint_path=args.checkpoint,
        output=args.out,
        engine=engine,
        fill=args.fill,
    )


def cmd_render(args):
    import contextlib
    import os

    from distributed_raytracer_tpu_torch.render.image import write_ppm
    from distributed_raytracer_tpu_torch.render.progressive import render_progressive
    from distributed_raytracer_tpu_torch.utils.metrics import RenderMetrics

    scene, cam = _load(args)
    engine = _resolve_engine(args)
    device = "cpu" if args.cpu else None
    guard = contextlib.nullcontext()
    if args.sanitize:
        from distributed_raytracer_tpu_torch.utils.sanitize import nan_debug, preflight

        print("[sanitize] checked fwd+grad pre-flight...", file=sys.stderr)
        preflight(scene, cam, seed=args.seed, device=device)
        print("[sanitize] clean; rendering under nan_debug", file=sys.stderr)
        guard = nan_debug()
    culled = intersect_fn = None
    if args.accel == "culled":
        from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import (
            build_culled_scene,
            make_culled_intersect,
        )

        culled = build_culled_scene(scene, chunk=256 if engine == "mega" else 128)
        scene = culled.scene  # the reordered scene the culled engines trace
        if engine == "wavefront":
            # the reference engine intersects the culled scene through K12;
            # the mega and fused engines walk the CulledScene themselves
            intersect_fn, culled = make_culled_intersect(culled), None
    out = args.out or f"{args.config}.ppm"
    if args.checkpoint:
        with open(args.checkpoint + ".json", "w") as f:
            f.write(_job_config(args, engine).to_json())

    metrics = RenderMetrics()
    display = None
    if args.display:
        from distributed_raytracer_tpu_torch.render.display import LiveDisplay

        display = LiveDisplay(cam.image_width, cam.image_height, port=args.display_port,
                              spp_total=cam.samples_per_pixel).start()
        print(f"live view: {display.url}", file=sys.stderr)

    # fault injection between sample batches, once per job: a marker file
    # beside the checkpoint (or the output) lets a supervised restart run on
    chaos_mode, chaos_at = None, 0
    if args.chaos:
        chaos_mode, at = args.chaos.split(":")
        if chaos_mode not in ("crash", "hang"):
            raise SystemExit(f"--chaos {args.chaos}: the mode is crash or hang")
        chaos_at = int(at)
    chaos_marker = (args.checkpoint or out) + ".chaos"
    # a resumed render counts only the samples it traces
    last = [0]
    if args.checkpoint and not args.no_resume and os.path.exists(args.checkpoint):
        from distributed_raytracer_tpu_torch.render.progressive import AccumState

        last[0] = AccumState.load(args.checkpoint).samples_done
    t0 = time.time()

    def progress(state):
        metrics.add_rays(cam.num_pixels * max(0, state.samples_done - last[0]))
        last[0] = state.samples_done
        metrics.samples_done = state.samples_done
        el = time.time() - t0
        print(
            f"sample {state.samples_done}/{cam.samples_per_pixel} "
            f"({cam.num_pixels * state.samples_done / el:,.0f} rays/s) [{engine}]",
            file=sys.stderr,
        )
        if args.heartbeat:
            with open(args.heartbeat, "w") as f:
                f.write(str(state.samples_done))
        if args.snapshot_every and state.samples_done % args.snapshot_every == 0:
            write_ppm(out, state.mean_image())
        if display is not None:
            display.progress_cb()(state)
        if chaos_mode and state.samples_done >= chaos_at and not os.path.exists(chaos_marker):
            with open(chaos_marker, "w") as f:
                f.write(chaos_mode)
            if chaos_mode == "crash":
                print("chaos: crashing", file=sys.stderr, flush=True)
                os._exit(13)
            print("chaos: hanging", file=sys.stderr, flush=True)
            time.sleep(3600)

    fill_cb = None
    if args.fill == "shuffled" and (args.snapshot_every or display is not None):
        def fill_cb(img):
            # repaint while the shuffled fill streams in, chunk by chunk
            if args.snapshot_every:
                write_ppm(out, img)
            if display is not None:
                display.update(img, spp_done=0)

    try:
        with metrics.phase("render"), guard:
            state = render_progressive(
                scene, cam, seed=args.seed, spp=cam.samples_per_pixel, batch=args.batch,
                checkpoint_path=args.checkpoint, resume=not args.no_resume,
                progress_cb=progress, engine=engine, device=device, culled=culled,
                ray_order="tiled" if args.accel == "culled" else "row",
                resort_every=args.resort, use_pallas=args.pallas, intersect_fn=intersect_fn,
                fill=args.fill, fill_chunk=args.fill_chunk, fill_cb=fill_cb,
            )
        write_ppm(out, state.mean_image())
        metrics.report()
        print(f"wrote {out} [engine={state.engine}, device={'cpu' if args.cpu else 'cuda'}]",
              file=sys.stderr)
        if display is not None:
            display.update(state.mean_image(), spp_done=state.samples_done)
            if args.display_linger:
                print(f"final frame at {display.url}; ctrl-c to exit", file=sys.stderr)
                try:
                    while True:
                        time.sleep(1)
                except KeyboardInterrupt:
                    pass
    finally:
        if display is not None:
            display.close()


def cmd_supervise(args):
    from distributed_raytracer_tpu_torch.utils.supervise import Supervisor

    child = args.child
    if child and child[0] == "--":
        child = child[1:]
    hb = None
    for i, a in enumerate(child):
        if a == "--heartbeat" and i + 1 < len(child):
            hb = child[i + 1]
        elif a.startswith("--heartbeat="):
            hb = a.split("=", 1)[1]
    res = Supervisor(child, heartbeat=hb, stall_timeout=args.stall_timeout,
                     max_restarts=args.max_restarts, startup_grace=args.startup_grace).run()
    print(f"supervise: exit {res.exit_code} after {res.restarts} restart(s) "
          f"({','.join(res.events)})", file=sys.stderr)
    sys.exit(res.exit_code)


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


def build_parser() -> argparse.ArgumentParser:
    # no prefix abbreviations: --job's precedence finds the flags that were
    # typed by their exact tokens, which an abbreviation would slip past
    ap = argparse.ArgumentParser(prog="distributed_raytracer_tpu_torch", allow_abbrev=False)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="single-device progressive render", allow_abbrev=False)
    _add_common(p)
    p.add_argument("--job", default=None, metavar="FILE",
                   help="RenderJobConfig JSON file (utils/config.py) supplying defaults; "
                        "flags typed on the command line win")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path for resume (the job record goes to PATH.json)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                   help="write the progressive PPM every N samples (and after each chunk of "
                        "a shuffled fill)")
    p.add_argument("--engine", choices=["auto", "mega", "fused", "scan", "wavefront"],
                   default="auto",
                   help="mega = one kernel launch per image sample; fused = the wavefront "
                        "engine, one fused bounce launch per bounce of a ray pool; scan = "
                        "the reference bounce over ray tiles; wavefront = the reference "
                        "bounce over a ray pool (JAX's threefry noise).  auto = mega on the "
                        "card, scan with --cpu (wavefront with --accel culled)")
    p.add_argument("--wavefront", action="store_true",
                   help="--engine auto picks the wavefront engine")
    p.add_argument("--fill", choices=["row", "shuffled"], default="row",
                   help="shuffled = render sample 0 in shuffled pixel chunks first")
    p.add_argument("--fill-chunk", type=int, default=16384,
                   help="pixels per chunk of the shuffled fill (the repaint granularity)")
    p.add_argument("--pallas", action="store_true",
                   help="the wavefront engine intersects with the closest-hit kernel (K11)")
    p.add_argument("--accel", choices=["none", "culled"], default="none",
                   help="culled = render over Morton chunks with bounding spheres, each "
                        "ray sweeping only the chunks it can still hit")
    p.add_argument("--resort", type=int, default=0, metavar="K",
                   help="re-sort the wavefront engines' lanes every K bounces (--accel "
                        "culled; 0 = off)")
    p.add_argument("--display", action="store_true",
                   help="serve the progressive image over HTTP (render/display.py)")
    p.add_argument("--display-port", type=int, default=8642,
                   help="port for --display (0 = a free port)")
    p.add_argument("--display-linger", action="store_true",
                   help="keep serving the final frame after the render ends")
    p.add_argument("--sanitize", action="store_true",
                   help="the checked forward+gradient pre-flight on a small ray batch "
                        "(utils/sanitize.py), then the render under nan_debug")
    p.add_argument("--heartbeat", default=None, metavar="PATH",
                   help="write the sample count to PATH every progress step (stall "
                        "detection for `supervise`)")
    p.add_argument("--chaos", default=None, metavar="MODE:N",
                   help="fault injection: crash:N exits with code 13, hang:N sleeps, once "
                        "N samples are done (one-shot through a .chaos marker file)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser(
        "supervise", allow_abbrev=False,
        help="run a render under failure detection: restart on death, kill by pid and "
             "restart on a heartbeat stall")
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--stall-timeout", type=float, default=None,
                   help="seconds of heartbeat silence before kill and restart (needs "
                        "--heartbeat in the child's arguments)")
    p.add_argument("--startup-grace", type=float, default=None,
                   help="the stall window before an attempt's first beat (default 4x "
                        "--stall-timeout)")
    p.add_argument("child", nargs=argparse.REMAINDER,
                   help="-- render <flags...> (include --checkpoint)")
    p.set_defaults(fn=cmd_supervise)

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

    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed command line; `render --job FILE` fills every flag that
    was not typed from the job file (JAX's cli.py:728-751)."""
    args = build_parser().parse_args(argv)
    if getattr(args, "job", None):
        from distributed_raytracer_tpu_torch.utils.config import RenderJobConfig

        tokens = list(argv) if argv is not None else sys.argv[1:]

        def typed(flag):
            return any(a == flag or a.startswith(flag + "=") for a in tokens)

        with open(args.job) as f:
            job = RenderJobConfig.from_json(f.read())
        if not typed("--config") and job.preset:
            args.config = job.preset
        for attr, flag, value in (
            ("scene", "--scene", job.scene_path), ("seed", "--seed", job.seed),
            ("spp", "--spp", job.spp), ("batch", "--batch", job.batch),
            ("checkpoint", "--checkpoint", job.checkpoint_path),
            ("out", "--out", job.output), ("engine", "--engine", job.engine),
            ("fill", "--fill", job.fill),
        ):
            if not typed(flag) and value is not None:
                setattr(args, attr, value)
    return args


def main(argv=None):
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
