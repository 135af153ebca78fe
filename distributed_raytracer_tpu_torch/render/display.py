"""Live progressive display over HTTP (the port of distributed_raytracer_tpu/
render/display.py).

The renderer pushes each progressive mean image with `update()` (from
render_progressive's progress_cb, or the shuffled fill's fill_cb); the
frame is tonemapped by the native host runtime (native.tonemap_pack:
gamma-2 and a packed 0xFFRRGGBB word) into an uncompressed 32-bit BMP,
whose little-endian words are the BMP's BGRA bytes, so the frame is the
packed buffer behind a 54-byte header; native.tonemap_bytes gives the P6
PPM.  A browser polls `/` (a page that refreshes itself), `/frame.bmp`,
`/frame.ppm` or `/stats.json`.  The server is the standard library's
ThreadingHTTPServer on a daemon thread; port 0 binds a free port.
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from distributed_raytracer_tpu_torch import native

_PAGE = b"""<!doctype html>
<html><head><title>distributed_raytracer_tpu_torch live</title><style>
body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;max-width:96vw;margin-top:1em;
border:1px solid #333}
</style></head><body>
<div id=s>waiting for first frame&hellip;</div><img id=f>
<script>
async function tick(){
  try{
    const st=await (await fetch('stats.json')).json();
    document.getElementById('s').textContent=
      `frame ${st.frames}  spp ${st.spp_done}/${st.spp_total||'?'}  `+
      `${st.width}x${st.height}`;
    if(st.frames>0)document.getElementById('f').src='frame.bmp?v='+st.frames;
  }catch(e){}
}
setInterval(tick,500);tick();
</script></body></html>"""


def _bmp_from_argb(packed: np.ndarray, width: int, height: int) -> bytes:
    """Uncompressed BI_RGB 32-bit BMP around a packed-ARGB u32 buffer.

    Negative biHeight = top-down rows, so the buffer is embedded verbatim
    (no row flip): little-endian (a<<24|r<<16|g<<8|b) bytes out as
    b,g,r,a == BMP BGRA."""
    data = np.ascontiguousarray(packed, dtype="<u4").tobytes()
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 54 + len(data), 0, 0, 54,
        40, width, -height, 1, 32, 0, len(data), 2835, 2835, 0, 0,
    )
    return header + data


class LiveDisplay:
    """In-process live viewer.  `start()` binds (port=0 -> ephemeral) and
    serves on a daemon thread; `update(mean_rgb)` publishes a frame."""

    def __init__(self, width: int, height: int, port: int = 0,
                 host: str = "127.0.0.1", spp_total: Optional[int] = None):
        self.width, self.height = width, height
        self.spp_total = spp_total
        self._lock = threading.Lock()
        self._bmp: Optional[bytes] = None
        self._ppm: Optional[bytes] = None
        self._frames = 0
        self._spp_done = 0
        display = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE)
                elif path == "/frame.bmp":
                    self._frame("_bmp", "image/bmp")
                elif path == "/frame.ppm":
                    self._frame("_ppm", "image/x-portable-pixmap")
                elif path == "/stats.json":
                    with display._lock:
                        body = json.dumps(
                            dict(
                                frames=display._frames,
                                spp_done=display._spp_done,
                                spp_total=display.spp_total,
                                width=display.width,
                                height=display.height,
                            )
                        ).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def _frame(self, attr, ctype):
                with display._lock:
                    body = getattr(display, attr)
                if body is None:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, ctype, body)

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "LiveDisplay":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def update(self, mean_rgb: np.ndarray, spp_done: int = 0) -> None:
        """Publish a linear mean image ([H,W,3] or [H*W,3] float)."""
        rgb = np.asarray(mean_rgb, np.float32).reshape(self.height, self.width, 3)
        packed = native.tonemap_pack(rgb)
        bmp = _bmp_from_argb(packed, self.width, self.height)
        ppm = (
            f"P6\n{self.width} {self.height}\n255\n".encode()
            + native.tonemap_bytes(rgb).tobytes()
        )
        with self._lock:
            self._bmp, self._ppm = bmp, ppm
            self._frames += 1
            self._spp_done = spp_done

    def progress_cb(self):
        """Adapter for render_progressive's progress_cb(AccumState)."""

        def cb(state):
            self.update(state.mean_image(), spp_done=int(state.samples_done))

        return cb

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
