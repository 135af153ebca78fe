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
"""

from __future__ import annotations

import argparse
import sys
import time


def _load(args):
    from distributed_raytracer_tpu_torch.models.presets import get_config
    from distributed_raytracer_tpu_torch.ops.camera import make_camera

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


def _device(args):
    from distributed_raytracer_tpu_torch.core.device import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def _add_common(p):
    p.add_argument("--config", default="config1", help="preset name (config1..config5)")
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
