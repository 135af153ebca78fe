"""Host ms of one build and upload of the walk's pack, which
render_progressive makes once a call: the program's count of builds and
their seconds (the run's warm-up included), averaged.  None where the
program keeps no such count or built no pack."""

from distributed_raytracer_tpu_torch.render.progressive import render_progressive


def read(rec):
    n = getattr(render_progressive, "walk_packs", 0)
    return 1e3 * render_progressive.walk_pack_s / n if n else None
