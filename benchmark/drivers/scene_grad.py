"""Scene-gradient steps: a closed loop of inverse-rendering steps, each
one sample of every pixel through the program's scene-gradient tracer,
the mean squared error against a target image, the backward pass to the
scene's five differentiable fields, and the loss read on the host.

The tracer is the program's camera tracer up to 512 spheres and its walk
tracer past them (the program's own dividing line); it is built once in
set-up with two tracer seeds drawn from --seed, so every step traces the
same paths of the same scene, as a fixed-noise gradient evaluation does.
No optimizer runs: the parameters do not change between steps.

Check: every step's loss, and the gradients of a sample of steps drawn
from --seed (the last step always in it), against the reference's loss
and gradients of the same pixels, seeds, scene and target: the worst
relative gap of the loss; per field the 90th percentile over spheres of
the relative gap of a sphere's gradient (sphere_p90_rel_err), which a
fault of many spheres fails; and per field the norm of the gradient's
difference over the norm of the reference's (field_rel_err), which a
fault of a few spheres fails.  Both are taken by the worst field and step.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import port
from benchmark.drivers.progressive import SEED_SPACE, rng_for
from benchmark.reference import camera as ref_camera
from benchmark.reference import tracer
from benchmark.reference.scenes import make_scene

FIELDS = ("centers", "radii", "albedo", "fuzz", "ior")


def sphere_p90_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The 90th percentile, over the spheres whose gradient is not zero on
    either side, of |got_i - ref_i| / (|ref_i| + the median |ref_j|), row
    norms of one field.  Steady where the norm is not: one ray that grazes
    a sphere gives it a derivative as large as 1/sqrt(disc), which the
    program's replay and the reference round apart, and that one sphere
    can set the norm of the whole field."""
    r = ref.reshape(ref.shape[0], -1).double()
    e = (got.reshape(r.shape).double() - r).norm(dim=1)
    s = r.norm(dim=1)
    live = (s > 0) | (e > 0)
    if not live.any():
        return 0.0
    rel = e[live] / (s[live] + s[s > 0].median() if (s > 0).any() else 1.0)
    return float(torch.quantile(rel, 0.9))


def field_rel_err(got: torch.Tensor, ref: torch.Tensor, floor: float):
    """(|got - ref| / max(|ref|, floor), the share of |got - ref|^2 in its
    largest sphere row) of one field."""
    d = (got.double() - ref.double()).reshape(ref.shape[0], -1)
    sq = (d * d).sum(dim=1)
    total = float(sq.sum())
    return (total ** 0.5 / max(float(ref.double().norm()), floor),
            float(sq.max()) / total if total > 0 else 0.0)


KEEP_FROM = 64  # the sampled steps are drawn among the first KEEP_FROM


class Driver:
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int, device):
        self.cfg, self.traffic, self.check_cfg = config, traffic, check
        self.seed, self.dev = seed, torch.device(device)

    def setup(self) -> None:
        cam = self.cfg["camera"]
        self.width, self.height = ref_camera.image_size(cam)
        self.n_pix = self.width * self.height
        self.arrays = make_scene(self.cfg["scene"], self.seed)
        scene = port.scene(self.arrays)
        self.camera = port.camera(cam, 1)
        rng = rng_for(self.seed, 1)
        self.bounce_seed, self.cam_seed = (int(x) for x in rng.integers(0, SEED_SPACE, 2))
        gen = torch.Generator(device=self.dev).manual_seed(int(rng.integers(0, 2**62)))
        self.target = torch.rand(self.n_pix, 3, generator=gen, device=self.dev)
        k = int(self.check_cfg["steps"])
        self.keep = {int(i) for i in rng_for(self.seed, 3).choice(KEEP_FROM, k, replace=False)}
        if port.mega_render_supported(scene):
            self.tracer = port.make_tape_camera_tracer(self.camera, self.bounce_seed,
                                                       self.cam_seed, iota_pix=True,
                                                       device=self.dev)
        else:
            self.tracer = port.make_tape_camera_walk_tracer(
                self.camera, self.bounce_seed, self.cam_seed, scene,
                chunk=int(self.traffic["walk_chunk"]), device=self.dev)
        self.scene = scene.to(self.dev)
        self.params = {k: getattr(self.scene, k).detach().clone().requires_grad_()
                       for k in FIELDS}
        self.ids = torch.arange(self.n_pix, device=self.dev)
        self.losses, self.grads, self.last = [], {}, None
        for _ in range(int(self.traffic["warmup_steps"])):
            self._step()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _step(self) -> float:
        for p in self.params.values():
            p.grad = None
        colors = self.tracer(self.scene.with_diff_params(self.params), self.ids)
        loss = port.image_loss(colors, self.target)
        loss.backward()
        return loss.item()

    def request(self, i: int) -> int:
        self.losses.append(self._step())
        g = self._grads()
        if i in self.keep:
            self.grads[i] = {k: v.clone() for k, v in g.items()}
        self.last = (i, g)
        return self.n_pix

    def _grads(self) -> dict:
        return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                for k, p in self.params.items()}

    def units(self, done: int) -> dict:
        return {"steps": done}

    def release(self) -> None:
        if self.last is not None:
            self.grads[self.last[0]] = self.last[1]
        self.grads = {i: {k: v.cpu() for k, v in g.items()} for i, g in self.grads.items()}
        self.tracer = self.scene = self.params = self.last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ----

    def reference(self, dtype):
        """(loss, {field: gradient}) of the reference for the traced pixels."""
        cam = self.cfg["camera"]
        s = tracer.Spheres(self.arrays, self.dev, dtype, grad=True)
        p = torch.arange(self.n_pix, device=self.dev)
        o, d = ref_camera.primary_rays(ref_camera.camera_row(cam), p, p, self.cam_seed,
                                       self.width, dtype)
        colors = tracer.trace(s, o, d, p, self.bounce_seed, int(cam["max_depth"]))
        loss = torch.mean((colors.float() - self.target) ** 2)
        loss.backward()
        return loss.item(), {k: v.grad.float().cpu() for k, v in s.leaves().items()}

    def put_reference(self, dtype) -> None:
        """The control: the reference computed at dtype, in the program's
        place as the answer of every step."""
        loss, grads = self.reference(dtype)
        self.losses = [loss] * len(self.losses)
        self.grads = {i: grads for i in self.grads}

    def check(self, dtype) -> dict:
        loss, ref = self.reference(dtype)
        loss_gap = max(abs(x - loss) for x in self.losses) / abs(loss)
        norms = {k: float(v.norm()) for k, v in ref.items()}
        median = float(np.median(list(norms.values())))
        counted = [k for k in FIELDS if norms[k] >= 1e-3 * median]
        p90 = {k: max(sphere_p90_rel_err(g[k], ref[k]) for g in self.grads.values())
               for k in counted}
        by_field = {k: max(field_rel_err(g[k], ref[k], median) for g in self.grads.values())
                    for k in counted}
        self.detail = {"grad_p90_rel_err_by_field": p90,
                       "grad_norm_rel_err_by_field": {k: v[0] for k, v in by_field.items()},
                       "top_sphere_share_by_field": {k: v[1] for k, v in by_field.items()},
                       "reference_norms": norms}
        return {"loss_rel_err": loss_gap, "grad_p90_rel_err": max(p90.values()),
                "grad_norm_rel_err": max(v[0] for v in by_field.values())}

    def work_sample(self) -> dict:
        """The reference's counts of the traced sample: closest hits run,
        their tests with a discriminant not negative, live spheres."""
        cam = self.cfg["camera"]
        s = tracer.Spheres(self.arrays, self.dev)
        p = torch.arange(self.n_pix, device=self.dev)
        o, d = ref_camera.primary_rays(ref_camera.camera_row(cam), p, p, self.cam_seed,
                                       self.width)
        counts = {"bounces": 0, "near": 0}
        with torch.no_grad():
            tracer.trace(s, o, d, p, self.bounce_seed, int(cam["max_depth"]), counts)
        return {**counts, "live": s.live}
