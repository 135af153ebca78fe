"""The shuffled fill, the checkpoint cadence and the checkpoint repair of
the port's render_progressive, on the CPU, against the JAX package.

The scan engine's fill keys, permutation and padding are JAX's, so JAX's
render_progressive(fill="shuffled", engine="scan") on config1 at 48x27,
depth 8, fill_chunk 1000 (a padded second chunk) is held pixel by pixel at
the depth-8 bands of test_torch_renderer.py (max < 5e-4, mean < 5e-6), the
pixels each chunk fills exactly.  The fused and mega fills run the dense
fused engine, whose draws are the port's own (ROADMAP Queue 3), so they
are held to the fused engine called with the same ids and seeds, bit for
bit, and for coverage, monotone snapshots and determinism.  JAX runs once
per module."""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu import native as jnative
from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.render import progressive as jprog
from distributed_raytracer_tpu_torch import native
from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.render import progressive
from distributed_raytracer_tpu_torch.render.progressive import AccumState, render_progressive
from distributed_raytracer_tpu_torch.render.wavefront import render_wavefront_sum_fused
from test_torch_scene import to_port
from test_torch_trace import small_camera

BAND_MAX, BAND_MEAN = 5e-4, 5e-6
CHUNK = 1000


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def small():
    scene, cam = jp.config1()
    cam = small_camera(cam, 48)
    return (scene, cam), to_port(scene, cam)


def _filled(snapshots):
    return [np.flatnonzero(s.reshape(-1, 3).sum(-1) != 0) for s in snapshots]


@pytest.fixture(scope="module")
def jax_fill(small):
    (scene, cam), _ = small
    snaps = []
    st = jprog.render_progressive(scene, cam, seed=0, spp=2, batch=2, fill="shuffled",
                                  fill_chunk=CHUNK, fill_cb=lambda im: snaps.append(im.copy()))
    return st, snaps


def test_scan_fill_matches_jax(small, jax_fill):
    _, (scene, cam) = small
    want, want_snaps = jax_fill
    snaps = []
    got = render_progressive(scene, cam, seed=0, spp=2, batch=2, fill="shuffled",
                             fill_chunk=CHUNK, engine="scan", device="cpu",
                             fill_cb=lambda im: snaps.append(im.copy()))
    assert got.samples_done == want.samples_done == 2
    # the permutation: JAX's seed from its threefry randint, the same C++ shuffle
    import jax

    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 0x5F111)
    key = prng.fold_in(prng.PRNGKey(0), progressive.FILL_FOLD)
    n = cam.num_pixels
    seed = int(prng.randint(key, (), 0, 2**31 - 1))
    assert seed == int(jax.random.randint(jkey, (), 0, 2**31 - 1))
    np.testing.assert_array_equal(native.shuffled_indices(n, seed),
                                  jnative.shuffled_indices(n, seed))
    # each chunk fills the same pixels; the colors agree at the depth-8 bands
    assert len(snaps) == len(want_snaps) == -(-n // CHUNK)
    for a, b in zip(_filled(snaps), _filled(want_snaps)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(snaps + [got.raw_sum], want_snaps + [want.raw_sum]):
        d = np.abs(a - np.asarray(b)).reshape(-1, 3)
        assert d.max() < BAND_MAX and d.mean() < BAND_MEAN, (d.max(), d.mean())


@pytest.mark.parametrize("engine,pool", [("fused", None), ("mega", None), ("fused", 300)])
def test_fused_fill_mechanics(small, engine, pool):
    """The mega and fused fills are the dense fused engine on each chunk's
    ids at the chunk key's seeds (a pool of 2048 on the mega engine and
    16384 on the fused one unless given, cut to the chunk), bit for bit;
    every pixel is filled once, the snapshots fill in monotonically, and a
    second run is bit-identical; samples 1.. are the engine's batches."""
    _, (scene, cam) = small
    snaps = []
    kw = dict(seed=4, spp=3, batch=2, fill="shuffled", fill_chunk=CHUNK, engine=engine,
              pool_size=pool, device="cpu")
    st = render_progressive(scene, cam, fill_cb=lambda im: snaps.append(im.copy()), **kw)
    assert st.samples_done == 3 and np.isfinite(st.raw_sum).all()
    filled = [len(f) for f in _filled(snaps)]
    assert filled == sorted(filled) and filled[0] < filled[-1]

    n = cam.num_pixels
    key = prng.fold_in(prng.PRNGKey(4), progressive.FILL_FOLD)
    perm = native.shuffled_indices(n, int(prng.randint(key, (), 0, 2**31 - 1)))
    raw = np.zeros((n, 3), np.float32)
    count = np.zeros(n, np.int32)
    want_pool = min(pool or (2048 if engine == "mega" else 16384), CHUNK)
    for c0 in range(0, n, CHUNK):
        ids = perm[c0:c0 + CHUNK]
        padded = np.pad(ids, (0, CHUNK - len(ids)))
        colors = render_wavefront_sum_fused(scene, cam, 1, *prng.seed_pair(prng.fold_in(key, c0)),
                                            pool_size=want_pool, pixel_ids=padded, device="cpu")
        native.accumulate(raw, count, colors[:len(ids)].numpy(), ids)
    assert (count == 1).all()
    np.testing.assert_array_equal(snaps[-1].reshape(-1, 3), raw)
    # samples 1-2: the batch that starts at sample 1 (batch_seeds(4, 1))
    np.testing.assert_array_equal(st.raw_sum, raw + _batch_at(scene, cam, engine, pool, 4, 1, 2))
    again = render_progressive(scene, cam, **kw)
    np.testing.assert_array_equal(again.raw_sum, st.raw_sum)


def _batch_at(scene, cam, engine, pool, seed, done, n):
    """The sum of the batch of n samples that starts at sample done."""
    from distributed_raytracer_tpu_torch.ops.kernels.mega_render_kernel import (
        render_wavefront_sum_mega,
    )

    seeds = progressive.batch_seeds(seed, done)
    if engine == "mega":
        out = render_wavefront_sum_mega(scene, cam, n, *seeds, device="cpu")
    else:
        out = render_wavefront_sum_fused(scene, cam, n, *seeds, pool_size=pool or 16384,
                                         device="cpu")
    return out.numpy()


def test_checkpoint_every_and_final_save(small, tmp_path, monkeypatch):
    _, (scene, cam) = small
    saves = []
    real = AccumState.save

    def save(self, path):
        saves.append(self.samples_done)
        real(self, path)

    monkeypatch.setattr(AccumState, "save", save)
    ckpt = str(tmp_path / "c.npz")
    st = render_progressive(scene, cam, seed=1, spp=5, batch=1, engine="mega", device="cpu",
                            checkpoint_path=ckpt, checkpoint_every=2)
    assert saves == [2, 4, 5]  # every second batch, then the final save
    assert AccumState.load(ckpt).samples_done == 5
    saves.clear()
    render_progressive(scene, cam, seed=2, spp=3, batch=1, engine="mega", device="cpu",
                       checkpoint_path=ckpt, checkpoint_every=5, fill="shuffled",
                       fill_chunk=CHUNK)
    assert saves == [1, 3]  # after the fill, then the final save
    # a render killed after a save resumes to the uninterrupted sum bit for bit
    whole = render_progressive(scene, cam, seed=3, spp=4, batch=1, engine="mega", device="cpu",
                               fill="shuffled", fill_chunk=CHUNK)
    ck2 = str(tmp_path / "d.npz")
    render_progressive(scene, cam, seed=3, spp=2, batch=1, engine="mega", device="cpu",
                       fill="shuffled", fill_chunk=CHUNK, checkpoint_path=ck2)
    resumed = render_progressive(scene, cam, seed=3, spp=4, batch=1, engine="mega",
                                 device="cpu", fill="shuffled", fill_chunk=CHUNK,
                                 checkpoint_path=ck2)
    np.testing.assert_array_equal(resumed.raw_sum, whole.raw_sum)
    assert st.raw_sum.shape == (cam.num_pixels, 3)


def test_load_defaults_for_old_checkpoints(small, tmp_path):
    """A checkpoint written before the engine and batch fields existed
    loads in both packages as the scan engine's, batch 0."""
    _, (_, cam) = small
    path = str(tmp_path / "old.ckpt")
    raw = np.random.default_rng(0).random((cam.num_pixels, 3)).astype(np.float32)
    with open(path, "wb") as f:
        np.savez(f, raw_sum=raw, samples_done=3, seed=11, image_width=cam.image_width,
                 image_height=cam.image_height)
    got, want = AccumState.load(path), jprog.AccumState.load(path)
    for k in ("samples_done", "seed", "image_width", "image_height", "engine", "batch"):
        assert getattr(got, k) == getattr(want, k), k
    assert (got.engine, got.batch) == ("scan", 0)
    np.testing.assert_array_equal(got.raw_sum, want.raw_sum)


def test_batch_seeds_500_match_jax():
    import jax

    k = jax.random.fold_in(jax.random.PRNGKey(0), 500)
    want = (int(jax.random.randint(k, (), 0, 2**31 - 1)),
            int(jax.random.randint(jax.random.fold_in(k, 0xCA3), (), 0, 2**31 - 1)))
    assert progressive.batch_seeds(0, 500) == want


def test_unknown_fill_is_refused(small):
    _, (scene, cam) = small
    with pytest.raises(ValueError, match="unknown fill"):
        render_progressive(scene, cam, spp=1, fill="spiral", device="cpu")
