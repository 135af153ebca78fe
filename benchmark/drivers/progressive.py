"""Progressive renders: a closed loop of one client, each request the
configuration's own image (its samples per pixel, in batches) through the
program's `render_progressive`, from submission until the mean image is in
host memory.  After each batch the program hands the client its snapshot,
the running sum in host memory; the gaps between snapshots are the
progressive user's waits.  Each request has its own render seed, drawn
from --seed.

Check: a sample of the window's images (drawn from --seed, the last one
always in it), each at a sample of pixels (drawn from --seed), against
the reference's trace of the same pixels with the same seeds, summed and
averaged as the program sums them.  The number compared is the share of
(image, pixel, channel) values that differ by more than float32 rounding.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import port
from benchmark.reference import camera as ref_camera
from benchmark.reference import draws, tracer
from benchmark.reference.scenes import make_scene

SEED_SPACE = 2**31 - 1
ATOL, RTOL = 1e-6, 1e-5  # float32 rounding of a mean of a few samples


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


class Driver:
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int, device):
        self.cfg, self.traffic, self.check_cfg = config, traffic, check
        self.seed, self.dev = seed, torch.device(device)
        self.spp = int(config["camera"]["samples_per_pixel"])
        self.batch = int(traffic["batch"])

    def setup(self) -> None:
        cam = self.cfg["camera"]
        self.width, self.height = ref_camera.image_size(cam)
        self.n_pix = self.width * self.height
        self.arrays = make_scene(self.cfg["scene"], self.seed)
        self.scene = port.scene(self.arrays)
        self.camera = port.camera(cam, self.spp)
        rng = rng_for(self.seed, 1)
        self.warm_seeds = rng.integers(0, SEED_SPACE, int(self.traffic["warmup_requests"]))
        self.seeds = rng.integers(0, SEED_SPACE, int(self.traffic["max_requests"]))
        k = min(int(self.check_cfg["pixels"]), self.n_pix)
        self.pixels = np.sort(rng_for(self.seed, 2).choice(self.n_pix, k, replace=False))
        self.kept, self.gaps = [], []
        # the shapes of a request: a whole batch and the shorter last one
        warm_spp = self.batch + self.spp % self.batch if self.spp > self.batch else self.spp
        for s in self.warm_seeds:
            self._render(int(s), warm_spp)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _render(self, seed: int, spp: int, snapshot=None) -> np.ndarray:
        st = port.render_progressive(self.scene, self.camera, seed=seed, spp=spp,
                                     batch=self.batch, engine=self.traffic["engine"],
                                     device=self.dev, progress_cb=snapshot)
        return st.mean_image()

    def request(self, i: int) -> int:
        last = [time.perf_counter()]

        def snapshot(state):
            now = time.perf_counter()
            self.gaps.append(now - last[0])
            last[0] = now

        img = self._render(int(self.seeds[i]), self.spp, snapshot)
        self.kept.append(img.reshape(-1, 3)[self.pixels])
        return self.n_pix * self.spp

    def units(self, done: int) -> dict:
        return {"images": done, "samples": done * self.spp,
                "batches": done * -(-self.spp // self.batch)}

    def release(self) -> None:
        self.scene = self.camera = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ----

    def reference_images(self, seeds, pix: np.ndarray, dtype) -> list:
        """[len(pix), 3] mean colors of each request with these seeds: the
        rays of every (request, batch, sample, pixel) traced together,
        then summed in the program's order (samples of a batch on the
        device, batches into a float32 sum on the host)."""
        cam = self.cfg["camera"]
        p = torch.as_tensor(pix, dtype=torch.int64, device=self.dev)
        blocks = []  # (request, batch size, bounce seed, camera seed)
        for i, seed in enumerate(seeds):
            for done in range(0, self.spp, self.batch):
                blocks.append((i, min(self.batch, self.spp - done),
                               *draws.batch_seeds(int(seed), done)))
        pix_all, rid, bseed, cseed = [], [], [], []
        for _, n, bs, cs in blocks:
            smp = torch.arange(n, device=self.dev).repeat_interleave(len(pix))
            pix_all.append(p.repeat(n))
            rid.append((smp * self.n_pix + p.repeat(n)) & draws.M32)
            bseed.append(torch.full_like(smp, bs))
            cseed.append(torch.full_like(smp, cs))
        pix_all, rid = torch.cat(pix_all), torch.cat(rid)
        o, d = ref_camera.primary_rays(ref_camera.camera_row(cam), pix_all, rid,
                                       torch.cat(cseed), self.width, dtype)
        colors = tracer.trace(tracer.Spheres(self.arrays, self.dev, dtype), o, d, rid,
                              torch.cat(bseed), int(cam["max_depth"]))
        raws = [np.zeros((len(pix), 3), np.float32) for _ in seeds]
        at = 0
        for i, n, _, _ in blocks:
            acc = None
            for _ in range(n):
                c = colors[at:at + len(pix)]
                acc = c if acc is None else acc + c
                at += len(pix)
            raws[i] = raws[i] + acc.float().cpu().numpy()
        return [raw / self.spp for raw in raws]

    def _checked(self) -> list:
        """The images compared: a sample drawn from --seed, and the last."""
        n = len(self.kept)
        k = min(int(self.check_cfg["images"]), n)
        pick = rng_for(self.seed, 3).choice(n - 1, k - 1, replace=False) if k > 1 else []
        return sorted({int(i) for i in pick} | {n - 1})

    def put_reference(self, dtype) -> None:
        """The control: the reference computed at dtype, in the program's
        place as the answer of each image that is compared."""
        idx = self._checked()
        for i, img in zip(idx, self.reference_images([self.seeds[i] for i in idx],
                                                     self.pixels, dtype)):
            self.kept[i] = img

    def check(self, dtype) -> dict:
        idx = self._checked()
        refs = self.reference_images([self.seeds[i] for i in idx], self.pixels, dtype)
        bad = total = 0
        for i, ref in zip(idx, refs):
            got = self.kept[i]
            bad += int((np.abs(got - ref) > ATOL + RTOL * np.abs(ref)).sum())
            total += ref.size
        return {"pixel_mismatch_pct": 100.0 * bad / total}

    def work_sample(self) -> dict:
        """The reference's counts of one full sample of the first request:
        closest hits run, their tests with a discriminant not negative,
        live spheres."""
        cam = self.cfg["camera"]
        s = tracer.Spheres(self.arrays, self.dev)
        p = torch.arange(self.n_pix, device=self.dev)
        bs, cs = draws.batch_seeds(int(self.seeds[0]), 0)
        o, d = ref_camera.primary_rays(ref_camera.camera_row(cam), p, p, cs, self.width)
        counts = {"bounces": 0, "near": 0}
        with torch.no_grad():
            tracer.trace(s, o, d, p, bs, int(cam["max_depth"]), counts)
        return {**counts, "live": s.live}
