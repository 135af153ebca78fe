"""Progressive accumulation with checkpoint and resume.

The port of distributed_raytracer_tpu/render/progressive.py for four
engines: "scan" (render/renderer.py, the reference bounce over ray
tiles), "wavefront" (render/wavefront.py's reference engine, the dense
closest hit, K11 with use_pallas, or a given intersect_fn such as the
culled K12/K13), "mega" (the dense kernel up to 512 spheres, the walk
past them, or the walk over a given CulledScene; progressive.py:121-189
there) and "fused" (the fused wavefront engine, dense or over a
CulledScene; progressive.py:192-263).  The port's mega engine renders any
scene and image, so it never falls back to the fused one as JAX's does
(progressive.py:393-408), and its fused engine renders a batch in one
call (JAX's max_posdrain_spp sub-chunking is TPU scheduling).  The state
is (raw_sum, samples_done, seed) and is saved atomically after sample
batches, so a lost process resumes from its last batch.

Noise: the scan and wavefront engines take JAX's threefry keys exactly
as JAX's do (core/prng.py): key = PRNGKey(seed); the scan engine folds in
each global sample index, so its sum does not depend on the batch split,
and the wavefront engine renders the batch that starts at samples_done
from fold_in(key, samples_done).  Both give JAX's noise, pixel for pixel
to float32 rounding.  The mega and fused engines render each batch with
JAX's two int32 seeds of the batch key k = fold_in(PRNGKey(seed),
samples_done): randint(k) and randint(fold_in(k, 0xCA3))
(progressive.py:458, mega_render_kernel.py:549-554; core/prng.py
seed_pair), so the mega, walk and culled fused engines draw JAX's noise
at the same seed; the dense fused engine keys its bounce draws by ray id
where the TPU kernel draws on the core (ops/kernels/bounce_kernel.py), so
it gives the same estimator with other noise.  Within the port, resume is
bit-identical when the batch size matches the checkpoint's (any batch
size on the scan engine).

fill="shuffled" renders sample 0 in shuffled pixel chunks before the
batches, with JAX's keys, permutation (native.shuffled_indices of a
threefry randint) and padding, so the scan engine's fill is JAX's pixel
for pixel to float32 rounding; the mega and fused engines fill through
the dense fused engine (K10), whose draws are keyed by ray id where the
TPU kernel draws on the core, as above.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch import native
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops.camera import Camera, generate_rays
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import CulledScene
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import (
    mega_render_supported,
    render_wavefront_sum_mega,
)
from distributed_raytracer_tpu_torch.ops.kernels.mega_walk_kernel import (
    build_walk_pack,
    render_wavefront_sum_mega_walk,
    walk_pack_for,
)
from distributed_raytracer_tpu_torch.ops.intersect import closest_hit
from distributed_raytracer_tpu_torch.ops.kernels.intersect_kernel import closest_hit_pallas
from distributed_raytracer_tpu_torch.ops.trace import trace_rays_fast
from distributed_raytracer_tpu_torch.render.order import tile_permutation
from distributed_raytracer_tpu_torch.render.renderer import DEFAULT_TILE, render_sample_batch
from distributed_raytracer_tpu_torch.render.wavefront import (
    DEFAULT_POOL,
    render_wavefront_sum,
    render_wavefront_sum_fused,
)

WALK_CHUNK = 256  # slots per walk chunk (progressive.py:171 in the JAX package)
ENGINES = ("scan", "wavefront", "mega", "fused")


@dataclasses.dataclass
class AccumState:
    """Progressive render state."""

    raw_sum: np.ndarray  # [H*W, 3] f32 linear color sum
    samples_done: int
    seed: int
    image_width: int
    image_height: int
    # engine and batch pin resume bit-identity: a batch's seeds depend on
    # the sample count at its start
    engine: str = "mega"
    batch: int = 0

    def mean_image(self) -> np.ndarray:
        denom = max(self.samples_done, 1)
        return (self.raw_sum / denom).reshape(self.image_height, self.image_width, 3)

    def save(self, path: str) -> None:
        # Atomic write: a crash mid-save must not corrupt the resume point.
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    raw_sum=self.raw_sum,
                    samples_done=self.samples_done,
                    seed=self.seed,
                    image_width=self.image_width,
                    image_height=self.image_height,
                    engine=self.engine,
                    batch=self.batch,
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "AccumState":
        with np.load(path) as z:
            return cls(
                raw_sum=z["raw_sum"],
                samples_done=int(z["samples_done"]),
                seed=int(z["seed"]),
                image_width=int(z["image_width"]),
                image_height=int(z["image_height"]),
                # a file written before these fields existed is the scan
                # engine's, whose resume takes any batch
                engine=str(z["engine"]) if "engine" in z.files else "scan",
                batch=int(z["batch"]) if "batch" in z.files else 0,
            )

    @classmethod
    def fresh(cls, camera: Camera, seed: int, engine: str = "mega", batch: int = 0) -> "AccumState":
        return cls(
            raw_sum=np.zeros((camera.num_pixels, 3), np.float32),
            samples_done=0,
            seed=seed,
            image_width=camera.image_width,
            image_height=camera.image_height,
            engine=engine,
            batch=batch,
        )


def batch_seeds(seed: int, samples_done: int) -> Tuple[int, int]:
    """(bounce_seed, cam_seed), non-negative int32, for the batch that
    starts at samples_done: JAX's pair of fold_in(PRNGKey(seed),
    samples_done)."""
    return prng.seed_pair(prng.fold_in(prng.PRNGKey(seed), samples_done))


FILL_FOLD = 0x5F111  # the fill's key, apart from every sample's (progressive.py:439)


def _shuffled_fill_sample(scene_dev: Scene, camera_dev: Camera, key: torch.Tensor,
                          fill_chunk: int, fill_cb, fused: bool, pool_size: int,
                          dev) -> np.ndarray:
    """Sample 0 rendered in chunks of fill_chunk pixels in a shuffled
    order; returns its color sum [H*W, 3].  fill_cb, if given, gets the
    mean image [H, W, 3] of the pixels filled so far after each chunk
    (the others black).  The order is shuffled_indices(n_pix,
    randint(key)); chunk c0 renders from fold_in(key, c0), a short last
    chunk padded with pixel 0 (its colors dropped; the scan engine's
    threefry draws depend on the batch shape).  With fused, a chunk is the
    dense fused engine (K10) at seed_pair(chunk key) and a pool of
    min(pool_size, chunk); else split(chunk key) gives the camera key and
    the trace key of the reference bounce (JAX's progressive.py:279-337)."""
    n_pix = camera_dev.num_pixels
    w = camera_dev.image_width
    perm = native.shuffled_indices(n_pix, seed=int(prng.randint(key, (), 0, prng.SEED_MAX)))
    chunk = min(fill_chunk, n_pix)
    raw = np.zeros((n_pix, 3), np.float32)
    count = np.zeros(n_pix, np.int32)
    for c0 in range(0, n_pix, chunk):
        ids = perm[c0:c0 + chunk]
        padded = torch.as_tensor(np.pad(ids, (0, chunk - len(ids))), device=dev,
                                 dtype=torch.int64)
        k = prng.fold_in(key, c0)
        if fused:
            colors = render_wavefront_sum_fused(scene_dev, camera_dev, 1, *prng.seed_pair(k),
                                                pool_size=min(pool_size, chunk),
                                                pixel_ids=padded, device=dev)
        else:
            k_cam, k_trace = prng.split(k)
            o, d = generate_rays(camera_dev, padded % w, padded // w, key=k_cam)
            dt = scene_dev.centers.dtype
            colors = trace_rays_fast(scene_dev, o.to(dt), d.to(dt), k_trace,
                                     camera_dev.max_depth)
        native.accumulate(raw, count, colors[:len(ids)].cpu().numpy(), ids)
        if fill_cb is not None:
            denom = np.maximum(count, 1).astype(np.float32)[:, None]
            fill_cb((raw / denom).reshape(camera_dev.image_height, w, 3))
    return raw


def _walk_pack(scene: Scene, camera: Camera, culled: Optional[CulledScene], dev):
    """The walk's pack for this call on dev: built on the host
    (walk_pack_for(chunk=WALK_CHUNK), or the given CulledScene in the
    camera's visit order) and uploaded, inside the profiler range
    render_progressive.walk_pack; the builds and their host seconds count
    into render_progressive.walk_packs and .walk_pack_s."""
    if culled is None:
        native.available()  # a first use compiles the native library: no part of a build
    t0 = time.perf_counter()
    with torch.profiler.record_function("render_progressive.walk_pack"):
        pack = (walk_pack_for(scene, camera, chunk=WALK_CHUNK) if culled is None else
                build_walk_pack(culled, camera.center.detach().cpu().numpy())).to(dev)
    render_progressive.walk_packs += 1
    render_progressive.walk_pack_s += time.perf_counter() - t0
    return pack


def render_progressive(
    scene: Scene,
    camera: Camera,
    seed: int = 0,
    spp: Optional[int] = None,
    batch: int = 16,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = True,
    progress_cb: Optional[Callable[[AccumState], None]] = None,
    engine: str = "mega",
    device=None,
    culled: Optional[CulledScene] = None,
    pool_size: Optional[int] = None,
    ray_order: str = "row",
    resort_every: int = 0,
    use_pallas: bool = False,
    intersect_fn=None,
    tile_size: int = DEFAULT_TILE,
    fill: str = "row",
    fill_chunk: int = 16384,
    fill_cb: Optional[Callable[[np.ndarray], None]] = None,
) -> AccumState:
    """Render spp samples per pixel in batches, checkpointing after every
    checkpoint_every batches and once at the end.  A compatible checkpoint (same seed, image size, engine tag and
    batch; any batch on the scan engine) is resumed; any other is started
    over.

    engine="scan": render/renderer.py's sample passes, tile_size rays a
    tile.  engine="wavefront": the reference wavefront engine with
    pool_size lanes (default 16384), the dense closest hit, K11 with
    use_pallas, or intersect_fn (which overrides it; for a culled
    intersect pass culled.scene as scene), ray_order "tiled" and
    resort_every as on the fused engine.

    engine="mega": a scene of at most 512 spheres with the dense kernel, a
    larger one with the walk (walk_pack_for(chunk=256), built once a call:
    _walk_pack counts it), or, given culled, the walk over that CulledScene
    in the camera's visit order; all give equal images at equal content.
    engine="fused": the fused wavefront engine (render/wavefront.py) with
    pool_size lanes (default 16384), dense or, given culled, through the
    culled fused bounce; with culled, ray_order="tiled" streams the pixels
    in 32x16 tiles and resort_every re-sorts the lanes (the dense engine
    ignores both, as the JAX engine does).  The engine tag of the state is
    the engine, with "+culled" when culled is given.

    fill="shuffled" renders sample 0 of a fresh render in shuffled chunks
    of fill_chunk pixels (_shuffled_fill_sample; fill_cb gets the partial
    image after each chunk): on the mega and fused engines through the
    dense fused engine (K10) with a pool of pool_size (default 2048 on the
    mega engine, 16384 on the fused one; a CulledScene is not used), on the
    others through the reference bounce, as JAX's scan fill; the batches
    then start at sample 1.

    progress_cb gets the state after each batch, once that batch's sum is
    in host memory; the raw_sum it sees is never written afterwards.  On
    the card the mega engine has the next batch queued by then
    (render_progressive.overlapped counts such batches); if that launch
    raises, the batch before it is still taken into the state and saved
    per checkpoint_every, though not called back."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if ray_order not in ("row", "tiled"):
        raise ValueError(f"unknown ray_order {ray_order!r}")
    if fill not in ("row", "shuffled"):
        raise ValueError(f"unknown fill {fill!r}")
    spp = spp if spp is not None else camera.samples_per_pixel
    dev = resolve_device(device)
    camera_dev = camera.to(dev)
    key = prng.PRNGKey(seed)
    if engine == "scan":
        scene_dev = scene.to(dev)

        def render(n, done):
            return render_sample_batch(scene_dev, camera_dev, key, range(done, done + n),
                                       tile_size)
    elif engine == "wavefront":
        scene_dev = scene.to(dev)
        ifn = intersect_fn or (closest_hit_pallas if use_pallas else closest_hit)
        perm = (tile_permutation(camera.image_width, camera.image_height)
                if ray_order == "tiled" else None)

        def render(n, done):
            return render_wavefront_sum(scene_dev, camera_dev, prng.fold_in(key, done), n,
                                        pool_size or DEFAULT_POOL, ifn, perm, resort_every)
    elif engine == "fused":
        if culled is None and (resort_every or ray_order == "tiled"):
            print("[render] lane re-sort and tiled ray order on the fused engine need a "
                  "CulledScene; ignored", file=sys.stderr)
        opts = dict(pool_size=pool_size or DEFAULT_POOL, culled=culled, device=dev)
        if culled is not None:
            opts["resort_every"] = resort_every
            if ray_order == "tiled":
                opts["pixel_perm"] = tile_permutation(camera.image_width, camera.image_height)
        scene_dev = scene.to(dev)

        def render(n, done):
            return render_wavefront_sum_fused(scene_dev, camera_dev, n,
                                              *batch_seeds(seed, done), **opts)
    elif culled is None and mega_render_supported(scene):
        scene_dev = scene.to(dev)

        def render(n, done):
            return render_wavefront_sum_mega(scene_dev, camera_dev, n,
                                             *batch_seeds(seed, done), device=dev)
    else:
        pack = _walk_pack(scene, camera, culled, dev)

        def render(n, done):
            return render_wavefront_sum_mega_walk(pack, camera_dev, n,
                                                  *batch_seeds(seed, done), device=dev)

    # resume must match the engine and whether it ran over a CulledScene,
    # whose ray order may differ (progressive.py:412-414)
    tag = engine + ("+culled" if culled is not None else "")
    state: Optional[AccumState] = None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state = AccumState.load(checkpoint_path)
        if (
            state.seed != seed
            or state.image_width != camera.image_width
            or state.image_height != camera.image_height
            or state.engine != tag
            or (engine != "scan" and state.batch != batch)
        ):
            state = None  # incompatible checkpoint: start over
    if state is None:
        state = AccumState.fresh(camera, seed, engine=tag, batch=batch)

    if fill == "shuffled" and state.samples_done == 0:
        fused = engine in ("fused", "mega")
        fill_pool = pool_size or (2048 if engine == "mega" else DEFAULT_POOL)
        state.raw_sum = state.raw_sum + _shuffled_fill_sample(
            scene.to(dev), camera_dev, prng.fold_in(key, FILL_FOLD), fill_chunk, fill_cb,
            fused, fill_pool, dev)
        state.samples_done = 1
        if checkpoint_path:
            state.save(checkpoint_path)
        if progress_cb is not None:
            progress_cb(state)

    # The running sum stays on the device, each batch's sum added in place:
    # the adds numpy's raw_sum + delta did, in the same order and dtype.
    # On the card each new sum is copied into one of two pinned buffers
    # without blocking.  The mega engine's render() only queues launches,
    # so batch k+1 is queued before the host hands out batch k (saves,
    # calls back) and the card renders meanwhile; batch k+2's copy into
    # batch k's buffer is queued only after that.  The other engines read
    # back inside render() (scan waits for its last ray, fused and wavefront
    # count live lanes), so a lookahead would only hand each batch out one
    # batch later: they, and the CPU, hand out each batch once it is summed.
    on_card = dev.type == "cuda"
    lookahead = 1 if on_card and engine == "mega" else 0
    sum_dev = torch.tensor(state.raw_sum, device=dev)  # a copy: no array handed out is written
    pinned = []
    queued = []  # per batch: (samples done after it, its sum in host memory, the copy's event)
    since_save = 0

    def hand_out(cb):
        nonlocal since_save
        done, host, copied = queued.pop(0)
        if copied is not None:
            copied.synchronize()
        render_progressive.overlapped += len(queued)
        state.raw_sum = host.numpy().copy()
        state.samples_done = done
        since_save += 1
        if checkpoint_path and since_save >= checkpoint_every:
            state.save(checkpoint_path)
            since_save = 0
        if cb is not None:
            cb(state)

    for k, start in enumerate(range(state.samples_done, spp, batch)):
        try:
            delta = render(min(batch, spp - start), start)
        except BaseException:
            while queued:  # as without the lookahead: the batch before is in the state and saved
                hand_out(None)
            raise
        sum_dev = sum_dev.to(torch.promote_types(sum_dev.dtype, delta.dtype))
        sum_dev.add_(delta)
        done = min(start + batch, spp)
        if on_card:
            if len(pinned) < 2:
                pinned.append(torch.empty(sum_dev.shape, dtype=sum_dev.dtype, pin_memory=True))
            host = pinned[k % 2]
            host.copy_(sum_dev, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(dev))
            queued.append((done, host, copied))
        else:
            queued.append((done, sum_dev, None))
        while len(queued) > lookahead:
            hand_out(progress_cb)
    while queued:
        hand_out(progress_cb)
    if checkpoint_path:
        state.save(checkpoint_path)
    return state


render_progressive.overlapped = 0  # batches handed out while the next was already queued
render_progressive.walk_packs = 0  # walk packs built (_walk_pack)
render_progressive.walk_pack_s = 0.0  # their host seconds
