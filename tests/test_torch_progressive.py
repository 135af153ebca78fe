"""Progressive render, checkpoint/resume and the CLI of the port, on the
CPU (plain version) at small sizes."""

import os

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch import cli
from distributed_raytracer_tpu_torch.models import presets
from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import render_wavefront_sum_mega
from distributed_raytracer_tpu_torch.render.image import read_ppm, to_bytes, write_ppm
from distributed_raytracer_tpu_torch.render.progressive import (
    AccumState,
    batch_seeds,
    render_progressive,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    scene, _ = presets.config2()
    camera = presets.make_camera(aspect_ratio=16.0 / 9.0, image_width=24,
                                 samples_per_pixel=4, max_depth=6)
    return scene, camera


def test_resume_is_bit_identical(small, tmp_path):
    scene, camera = small
    whole = render_progressive(scene, camera, seed=7, spp=4, batch=2, device="cpu")
    ckpt = str(tmp_path / "ck.npz")
    part = render_progressive(scene, camera, seed=7, spp=2, batch=2, device="cpu",
                              checkpoint_path=ckpt)
    assert part.samples_done == 2
    assert AccumState.load(ckpt).samples_done == 2
    resumed = render_progressive(scene, camera, seed=7, spp=4, batch=2, device="cpu",
                                 checkpoint_path=ckpt)
    assert resumed.samples_done == 4
    np.testing.assert_array_equal(resumed.raw_sum, whole.raw_sum)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_incompatible_checkpoint_restarts(small, tmp_path):
    scene, camera = small
    ckpt = str(tmp_path / "ck.npz")
    render_progressive(scene, camera, seed=1, spp=2, batch=2, device="cpu",
                       checkpoint_path=ckpt)
    # another seed, or another batch size, starts over
    fresh = render_progressive(scene, camera, seed=2, spp=2, batch=2, device="cpu")
    other = render_progressive(scene, camera, seed=2, spp=2, batch=2, device="cpu",
                               checkpoint_path=ckpt)
    np.testing.assert_array_equal(other.raw_sum, fresh.raw_sum)
    rebatched = render_progressive(scene, camera, seed=2, spp=4, batch=1, device="cpu",
                                   checkpoint_path=ckpt)
    assert rebatched.batch == 1 and rebatched.samples_done == 4
    # no resume: the checkpoint is ignored and overwritten
    again = render_progressive(scene, camera, seed=2, spp=2, batch=2, device="cpu",
                               checkpoint_path=ckpt, resume=False)
    np.testing.assert_array_equal(again.raw_sum, fresh.raw_sum)


def test_batches_and_progress(small):
    scene, camera = small
    seen = []
    state = render_progressive(scene, camera, seed=3, spp=5, batch=2, device="cpu",
                               progress_cb=lambda s: seen.append(s.samples_done))
    assert seen == [2, 4, 5]
    img = state.mean_image()
    assert img.shape == (camera.image_height, camera.image_width, 3)
    assert np.isfinite(img).all() and img.min() >= 0.0
    # each batch has its own seeds
    assert batch_seeds(3, 0) != batch_seeds(3, 2)
    assert all(0 <= s < 2**31 for s in batch_seeds(-5, 10))


def test_cpu_hands_out_each_batch_as_summed(small):
    """On the CPU there is no lookahead: no batch is handed out while the
    next is queued, and each snapshot is its own array, equal at the end
    to the float32 prefix sum, added on the host, of the batch sums."""
    scene, camera = small
    snaps = []
    before = render_progressive.overlapped
    state = render_progressive(scene, camera, seed=3, spp=5, batch=2, device="cpu",
                               progress_cb=lambda s: snaps.append(s.raw_sum))
    assert render_progressive.overlapped == before
    acc = np.zeros((camera.num_pixels, 3), np.float32)
    assert len(snaps) == 3
    for snap, done in zip(snaps, (0, 2, 4)):
        acc = acc + render_wavefront_sum_mega(scene, camera, min(2, 5 - done),
                                              *batch_seeds(3, done), device="cpu").numpy()
        np.testing.assert_array_equal(snap, acc)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(snaps) for b in snaps[i + 1:])
    assert state.raw_sum is snaps[-1]


def test_failed_batch_leaves_the_one_before_saved(small, tmp_path, monkeypatch):
    """A batch whose render raises propagates the error; the checkpoint
    then holds the batch before it, as summed on the host."""
    from distributed_raytracer_tpu_torch.render import progressive

    scene, camera = small
    calls = []

    def failing(*args, **kwargs):
        calls.append(args)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return render_wavefront_sum_mega(*args, **kwargs)

    monkeypatch.setattr(progressive, "render_wavefront_sum_mega", failing)
    ckpt = str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="launch failed"):
        render_progressive(scene, camera, seed=3, spp=6, batch=2, device="cpu",
                           checkpoint_path=ckpt)
    acc = np.zeros((camera.num_pixels, 3), np.float32)
    for done in (0, 2):
        acc = acc + render_wavefront_sum_mega(scene, camera, 2, *batch_seeds(3, done),
                                              device="cpu").numpy()
    back = AccumState.load(ckpt)
    assert back.samples_done == 4
    np.testing.assert_array_equal(back.raw_sum, acc)


def test_accum_state_round_trip(small, tmp_path):
    _, camera = small
    st = AccumState.fresh(camera, seed=9, batch=3)
    st.raw_sum[:] = np.arange(st.raw_sum.size, dtype=np.float32).reshape(st.raw_sum.shape)
    st.samples_done = 6
    path = str(tmp_path / "s.npz")
    st.save(path)
    back = AccumState.load(path)
    np.testing.assert_array_equal(back.raw_sum, st.raw_sum)
    assert (back.samples_done, back.seed, back.engine, back.batch) == (6, 9, "mega", 3)


def test_other_engines_not_ported(small):
    """Every engine of the JAX package is ported now: "scan" and
    "wavefront" render (tests/test_torch_renderer.py holds them to JAX),
    and only a name no package knows is refused."""
    scene, camera = small
    for engine in ("scan", "wavefront"):
        state = render_progressive(scene, camera, spp=1, engine=engine, device="cpu")
        assert state.engine == engine and np.isfinite(state.raw_sum).all()
    with pytest.raises(ValueError, match="unknown engine"):
        render_progressive(scene, camera, spp=1, engine="auto", device="cpu")


def test_cuda_default_without_card_raises(small, monkeypatch):
    scene, camera = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_progressive(scene, camera, spp=1)


def test_cli_render_cpu_writes_ppm(tmp_path):
    out = str(tmp_path / "x.ppm")
    ckpt = str(tmp_path / "x.ckpt.npz")
    cli.main(["render", "--config", "config5", "--width", "32", "--spp", "2",
              "--batch", "1", "--seed", "4", "--out", out, "--checkpoint", ckpt, "--cpu"])
    img = read_ppm(out)
    assert img.shape == (18, 32, 3)
    assert AccumState.load(ckpt).samples_done == 2
    # the top-center pixel is sky: bluish
    assert int(img[0, 16, 2]) > int(img[0, 16, 0])


def test_image_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    lin = rng.random((5, 7, 3)).astype(np.float32) * 1.2 - 0.1
    path = str(tmp_path / "i.ppm")
    write_ppm(path, lin)
    np.testing.assert_array_equal(read_ppm(path), to_bytes(lin))
