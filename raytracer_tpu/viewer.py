"""Progressive preview — the headless analog of the reference's live
window (WindowManager.h:79-93 redraws the framebuffer every frame; on a
headless accelerator host we stream accumulating previews to disk and
optionally serve them over HTTP).

`progressive_render` accumulates spp in batches and writes a tone-mapped
preview PNG after every batch — the image sharpens over time exactly
like the reference's window does in high-quality mode. `serve` starts a
tiny stdlib HTTP server with an auto-refreshing page showing the latest
preview (view with a browser or port-forward from the pod).
"""

from __future__ import annotations

import http.server
import os
import threading

import jax
import numpy as np


def progressive_render(
    scene, cam, cfg, key, out_path: str = "preview.png",
    spp_per_update: int | None = None, on_update=None,
):
    """Render cfg.spp in batches, rewriting `out_path` after each.
    Returns the final mean linear image. RNG is sample-keyed, so the
    result equals a single-pass render of the same cfg."""
    from raytracer_tpu.ops.tonemap import to_rgba8
    from raytracer_tpu.render import iter_spp_accumulation
    from raytracer_tpu.utils.image import write_png

    acc = np.zeros((cfg.height, cfg.width, 3), np.float32)
    for done, batch_sum in iter_spp_accumulation(
            scene, cam, cfg, key, integrator="megakernel",
            spp_per_batch=spp_per_update):
        acc += batch_sum
        preview = acc / done
        write_png(out_path, np.asarray(to_rgba8(preview)))
        if on_update:
            on_update(done, preview)
    return acc / cfg.spp


_PAGE = """<!doctype html><title>raytracer_tpu preview</title>
<body style="background:#111;margin:0;display:grid;place-items:center;height:100vh">
<img id="i" style="max-width:100vw;max-height:100vh;image-rendering:pixelated">
<script>setInterval(()=>{document.getElementById('i').src='/preview.png?'+Date.now()},1000)</script>
"""


def serve(directory: str, port: int = 8000, preview_name: str = "preview.png"):
    """Serve the preview directory with an auto-refreshing index page.
    Returns the http server thread (daemon)."""

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=directory, **kw)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _PAGE.replace("preview.png", preview_name).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                super().do_GET()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv
