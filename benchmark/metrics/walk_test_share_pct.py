"""The share of a dense sweep's ray x sphere tests that the walk runs:
slot tests over (bounces x the reference's live spheres), from the
program's walk tally (every render and record launch of the run, the
warm-up included), in %.  How well the chunks' bounds cull; None where
the program keeps no tally or launched no walk."""

from distributed_raytracer_tpu_torch.ops.kernels import mega_walk_kernel


def read(rec):
    take = getattr(mega_walk_kernel, "walk_tally", None)
    tally = take() if take is not None else None
    if not tally or not tally["bounces"]:
        return None
    return 100.0 * tally["tests"] / (tally["bounces"] * rec.work()["live"])
