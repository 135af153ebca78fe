"""The port's culled fused bounce (K14, plain version on the CPU) against
the JAX package's culled_fused_bounce (ops/pallas/culled_bounce_kernel.py)
in interpret mode, on tests/test_culled_fused.py:95-105's setup (the
RTiOW final scene in chunks of 128, 640 rays, ray ids 7k + 13), with the
same hash draws on both sides.

Bands: integer outputs equal; attenuation, color and the draws within
1e-6.  The next origin and direction of a scattered ray depend on the
sweep's t, which XLA:CPU and torch round differently (as for the dense
bounce, tests/test_torch_fused_bounce.py): both are held to the same
bounce in float64 at JAX's own kernel-vs-oracle bands (2e-3, 8e-3;
test_culled_fused.py:83-93), and the port to JAX at 1e-3 on the rays
without a grazing hit.  The port's pack holds the same spheres per chunk
and the same bounds as JAX's build_culled_pack, and its walk returns the
dense bounce over the culled scene bit for bit, with or without
culling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_raytracer_tpu.models import presets as jp
from distributed_raytracer_tpu.ops.pallas import culled_bounce_kernel as jcb
from distributed_raytracer_tpu.ops.pallas.culled_kernel import build_culled_scene as jax_culled
from distributed_raytracer_tpu_torch.ops.kernels import bounce_kernel as bk
from distributed_raytracer_tpu_torch.ops.kernels import culled_bounce_kernel as cb
from distributed_raytracer_tpu_torch.ops.kernels.culled_kernel import build_culled_scene
from test_torch_fused_bounce import FIELDS, _assert_matches, _grazing
from test_torch_scene import to_port

torch.set_num_threads(1)
SEED = 987654


@pytest.fixture(scope="module")
def setup():
    """The JAX test's scene, culled scene, pack and rays (made by JAX's
    own _rays), JAX's bounce in interpret mode, and the port's culled
    scene and pack."""
    scene = jp.rtiow_final_scene(seed=0, pad_to=512)
    jc = jax_culled(scene, chunk=128)
    jpack = jcb.build_culled_pack(jc)
    key = jax.random.PRNGKey(3)
    o = jax.random.normal(key, (640, 3)) * 2 + jnp.array([13.0, 2.0, 3.0])
    d = -o / jnp.linalg.norm(o, axis=-1, keepdims=True)
    d = d + 0.1 * jax.random.normal(jax.random.fold_in(key, 1), (640, 3))
    act = jnp.ones((640,), bool)
    rid = jnp.arange(640, dtype=jnp.int32) * 7 + 13
    with pltpu.force_tpu_interpret_mode():
        out = jcb.culled_fused_bounce(o, d, act, rid, jpack, jc.chunk, jnp.int32(SEED))
    want = {k: np.asarray(getattr(out, k)) for k in FIELDS}
    culled = build_culled_scene(to_port(scene), chunk=128)
    lanes = tuple(torch.from_numpy(np.array(x)) for x in (o, d, act, rid))
    return jc, jpack, want, culled, cb.build_culled_pack(culled), lanes


def _bounce(pack, lanes, dtype=torch.float32, stats=None):
    o, d, act, rid = lanes
    p = pack._replace(scene_pack=pack.scene_pack.to(dtype), attrs=pack.attrs.to(dtype))
    out = cb.culled_fused_bounce(o.to(dtype), d.to(dtype), act, rid, p, SEED, stats=stats)
    return {k: getattr(out, k).numpy() for k in FIELDS}


def test_matches_jax_interpret(setup):
    jc, _, want, _, pack, lanes = setup
    got = _bounce(pack, lanes)
    exact = _bounce(pack, lanes, torch.float64)
    _assert_matches(got, want, ("atten", "color", "finished", "idx", "hit", "ruv", "u"))
    o, d = (x.numpy() for x in lanes[:2])
    calm = ~_grazing(jc.scene, o, d, want["idx"], want["hit"])
    scattered = got["finished"] == 0
    assert got["hit"].mean() > 0.5 and scattered.mean() > 0.2 and calm.mean() > 0.5
    for k, band in (("new_o", 2e-3), ("new_d", 8e-3)):
        np.testing.assert_array_equal(got[k][~scattered], want[k][~scattered])
        assert np.abs(got[k] - exact[k]).max() < band, k
        assert np.abs(want[k] - exact[k]).max() < band, k
        assert np.abs(got[k] - want[k])[calm].max() < 1e-3, k


def test_culling_changes_nothing(setup):
    """The walk's winner is the dense argmin over the culled scene: with
    its bounds, with every bound infinite (nothing culled), and the dense
    bounce over culled.scene all give the same lanes bit for bit; the
    counters show what the bounds cull."""
    _, _, _, culled, pack, lanes = setup
    st, st_all = torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64)
    walked = _bounce(pack, lanes, stats=st)
    open_pack = pack._replace(bounds=torch.where(pack.bounds[:, 3:] >= 0,
                                                 torch.tensor([0.0, 0.0, 0.0, float("inf")]),
                                                 pack.bounds))
    unculled = _bounce(open_pack, lanes, stats=st_all)
    o, d, act, rid = lanes
    dense = bk.fused_bounce(o, d, act, rid, bk.fused_scene_arrays(culled.scene), SEED)
    for k in FIELDS:
        np.testing.assert_array_equal(walked[k], unculled[k], err_msg=k)
        np.testing.assert_array_equal(walked[k], getattr(dense, k).numpy(), err_msg=k)
    lanes_n, admitted, tests, near = st.tolist()
    live = int((culled.order >= 0).sum())
    assert lanes_n == 640 and st_all.tolist()[1:3] == [640 * pack.n_chunks, 640 * live]
    assert 640 <= admitted < 640 * pack.n_chunks and near <= tests < 640 * live


def test_pack_matches_jax(setup):
    """The port's pack (its own layout: [n, 4] sweep rows, [11, n] f32
    attributes) holds JAX's pack: the same sweep rows, the attributes that
    JAX's bf16 hi/mid/lo planes add up to, the same bounds per chunk."""
    _, jpack, _, culled, pack, _ = setup
    n = pack.n_slots
    np.testing.assert_array_equal(pack.scene_pack.numpy(), np.asarray(jpack.scene_pack)[:, :4])
    planes = np.asarray(jpack.attrs.astype(jnp.float32)).reshape(pack.n_chunks, 3, 16, 128)
    attrs = (planes[:, 0] + planes[:, 1] + planes[:, 2]).transpose(1, 0, 2).reshape(16, n)
    np.testing.assert_array_equal(pack.attrs.numpy(), attrs[:11])
    np.testing.assert_array_equal(pack.bounds.numpy()[:pack.n_chunks, :3],
                                  np.asarray(jpack.bounds_c))
    np.testing.assert_array_equal(pack.bounds.numpy()[:pack.n_chunks, 3],
                                  np.asarray(jpack.bounds_r2))
    np.testing.assert_array_equal(pack.slot_to_orig, culled.order)
    assert (pack.chunk, pack.n_chunks) == (128, 5)


def test_cuda_wrapper_rejects_cpu_tensors(setup):
    pack, (o, d, act, rid) = setup[4], setup[5]
    before = cb.culled_fused_bounce_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cb.culled_fused_bounce_cuda(o, d, act, rid, pack, SEED)
    assert cb.culled_fused_bounce_cuda.launches == before
