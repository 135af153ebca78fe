"""The port's CUDA kernel against its plain version on the card.

These need an NVIDIA card with nvcc; elsewhere they skip.  Run them on
the card with `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(--noconftest: tests/conftest.py imports jax, which a CUDA machine need not have)."""

import pytest
import torch

from distributed_raytracer_tpu_torch.models import presets
from distributed_raytracer_tpu_torch.ops.kernels import mega_render_kernel as mrk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("which,depth", [("config2", 8), ("final", 1), ("final", 8)])
def test_kernel_matches_plain_on_card(card, which, depth):
    scene = (presets.config2()[0] if which == "config2"
             else presets.rtiow_final_scene(pad_to=512))
    camera = presets.final_scene_camera(64).replace(max_depth=depth)
    cols, attrs, cam_row = mrk.prepare(scene, camera, card)
    n = camera.num_pixels
    kw = dict(bounce_seed=123456, cam_seed=987654, rid_base=5 * n, pix0=0, n_valid=n,
              n_cap=n, w=camera.image_width, max_depth=depth)
    before = mrk.mega_render_cuda.launches
    got, got_b = mrk.mega_render_sample(cols, attrs, cam_row, **kw)
    assert mrk.mega_render_cuda.launches == before + 1
    want, want_b = mrk.mega_render_plain(cols, attrs, cam_row, **kw)
    torch.cuda.synchronize()
    d = (got - want).abs()
    if depth == 1:
        assert float(d.max()) < 1e-6
    assert float(d.mean()) < 5e-6
    assert float((d.max(dim=1).values > 5e-4).float().mean()) <= 0.02
    assert abs(int(got_b) - int(want_b)) <= 0.001 * int(want_b)


def test_kernel_shard_zero_fills_capacity(card):
    scene, camera = presets.config2()
    camera = camera.replace(max_depth=4)
    cols, attrs, cam_row = mrk.prepare(scene, camera, card)
    colors, _ = mrk.mega_render_cuda(cols, attrs, cam_row, bounce_seed=1, cam_seed=2,
                                     rid_base=0, pix0=100, n_valid=300, n_cap=320,
                                     w=camera.image_width, max_depth=4)
    torch.cuda.synchronize()
    assert torch.count_nonzero(colors[300:]) == 0
    assert torch.isfinite(colors).all()
