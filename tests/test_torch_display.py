"""The port's live display (render/display.py) against the JAX package's
LiveDisplay on the CPU: both serve on a free port over loopback, and for
the same image their /frame.bmp and /frame.ppm are the same bytes; the
routes, the 503 before the first frame, /stats.json and the progress_cb
adapter."""

import dataclasses
import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributed_raytracer_tpu.render.display import LiveDisplay as JaxDisplay
from distributed_raytracer_tpu_torch.ops.camera import make_camera
from distributed_raytracer_tpu_torch.render.display import LiveDisplay, _bmp_from_argb
from distributed_raytracer_tpu_torch.render.image import pack_argb, to_bytes
from distributed_raytracer_tpu_torch.render.progressive import AccumState


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


@pytest.fixture
def displays():
    port = LiveDisplay(width=8, height=4, port=0, spp_total=16).start()
    ref = JaxDisplay(width=8, height=4, port=0, spp_total=16).start()
    yield port, ref
    port.close()
    ref.close()


def test_bmp_embeds_packed_argb_verbatim():
    rgb = np.random.default_rng(0).uniform(0, 1, (4, 8, 3)).astype(np.float32)
    packed = pack_argb(rgb)
    bmp = _bmp_from_argb(packed, 8, 4)
    assert bmp[:2] == b"BM"
    offset = struct.unpack_from("<I", bmp, 10)[0]
    bpp = struct.unpack_from("<H", bmp, 28)[0]
    height = struct.unpack_from("<i", bmp, 22)[0]
    assert (offset, bpp, height) == (54, 32, -4)  # top-down rows
    assert bmp[54:] == np.ascontiguousarray(packed, "<u4").tobytes()


def test_frames_are_jax_bytes(displays):
    port, ref = displays
    assert port.port != ref.port and port.url.startswith("http://127.0.0.1:")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port.url + "frame.bmp")
    assert e.value.code == 503
    rgb = np.random.default_rng(1).uniform(-0.1, 1.2, (4, 8, 3)).astype(np.float32)
    port.update(rgb, spp_done=5)
    ref.update(rgb, spp_done=5)
    for route, ctype in (("frame.bmp", "image/bmp"), ("frame.ppm", "image/x-portable-pixmap")):
        status, got_type, body = _get(port.url + route)
        _, want_type, want = _get(ref.url + route)
        assert (status, got_type) == (200, ctype) and got_type == want_type
        assert body == want, route
    _, _, ppm = _get(port.url + "frame.ppm")
    head, pixels = ppm.split(b"255\n", 1)
    assert head == b"P6\n8 4\n"
    np.testing.assert_array_equal(np.frombuffer(pixels, np.uint8).reshape(4, 8, 3), to_bytes(rgb))
    _, _, body = _get(port.url + "stats.json")
    assert json.loads(body) == dict(frames=1, spp_done=5, spp_total=16, width=8, height=4)
    assert json.loads(body) == json.loads(_get(ref.url + "stats.json")[2])
    status, ctype, body = _get(port.url)
    assert status == 200 and ctype.startswith("text/html") and b"frame.bmp" in body
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port.url + "nothing")
    assert e.value.code == 404


def test_progress_cb_adapter(displays):
    port, _ = displays
    cam = make_camera(aspect_ratio=2.0, image_width=8, samples_per_pixel=4)
    state = dataclasses.replace(AccumState.fresh(cam, seed=0),
                                raw_sum=np.full((cam.num_pixels, 3), 2.0, np.float32),
                                samples_done=2)
    port.progress_cb()(state)
    _, _, body = _get(port.url + "stats.json")
    assert json.loads(body)["spp_done"] == 2
    _, _, bmp = _get(port.url + "frame.bmp")
    assert bmp[54:] == np.ascontiguousarray(pack_argb(state.mean_image()), "<u4").tobytes()
