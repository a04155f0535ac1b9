"""Interactive web viewer: drag-to-orbit a 3DGS or 2DGS scene rendered live.

Port of ``examples/viewer.py``. A stdlib ``http.server`` serves one HTML
canvas page; every mouse drag requests ``/render?az=..&el=..&r=..``, which
renders the view and streams a PNG (``utils.image.encode_png``). The kernel
library is built by a first frame before the server starts, so no request
waits for a build.

    python -m mojosplat_tpu_torch.examples.viewer                  # random demo scene
    python -m mojosplat_tpu_torch.examples.viewer --ply scene.ply  # a trained scene
    python -m mojosplat_tpu_torch.examples.viewer --npz scene.npz  # a compressed scene

then open http://localhost:8090/. Runs on the card through the CUDA kernels
(``--device cuda --impl cuda``, the defaults); ``--device cpu --impl
torch`` on the CPU. A PLY with two scale columns is a 2DGS surfel scene.
The random scene is drawn by ``train.init_gaussians`` from a
``torch.Generator`` seeded with 42 (the reference's PRNGKey(42)); the
numbers differ from the reference's draws.

The server is single-threaded: requests render one after another.
"""

from __future__ import annotations

import argparse
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch

from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_gaussians, render_surfels
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.utils.image import encode_png, to_uint8

BACKGROUND = (0.08, 0.08, 0.10)
SEED = 42

PAGE = """<!doctype html>
<html><head><title>mojosplat-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
#hud { position:fixed; top:8px; left:10px; pointer-events:none; }
canvas { display:block; margin:0 auto; cursor:grab; }
</style></head><body>
<div id="hud">drag = orbit &nbsp; wheel = zoom &nbsp; <span id="ms"></span></div>
<canvas id="c" width="__W__" height="__H__"></canvas>
<script>
const c = document.getElementById('c'), hud = document.getElementById('ms');
let az = 0.0, el = 0.25, r = __R__, busy = false, dirty = true;
function fetchFrame() {
  if (busy) { return; }
  busy = true; dirty = false;
  const t0 = performance.now();
  const img = new Image();
  img.onload = () => {
    c.getContext('2d').drawImage(img, 0, 0);
    hud.textContent = Math.round(performance.now() - t0) + ' ms';
    busy = false;
    if (dirty) fetchFrame();
  };
  img.onerror = () => { busy = false; };
  img.src = `/render?az=${az.toFixed(4)}&el=${el.toFixed(4)}&r=${r.toFixed(4)}&t=${Date.now()}`;
}
let drag = null;
c.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  az += (e.clientX - drag[0]) * 0.01;
  el = Math.max(-1.5, Math.min(1.5, el + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  dirty = true; fetchFrame();
});
c.addEventListener('wheel', e => {
  e.preventDefault();
  r *= Math.exp(e.deltaY * 0.001);
  dirty = true; fetchFrame();
});
fetchFrame();
</script></body></html>
"""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ply", default=None)
    ap.add_argument("--npz", default=None, help="compressed scene")
    ap.add_argument("--gaussians", type=int, default=20000)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--focal", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--tile-capacity", type=int, default=512)
    return ap


def load_params(args, device) -> tuple[dict, int | None, bool]:
    """The raw parameters on ``device`` (a PLY, a compressed ``.npz``, or
    the seeded random cloud), the SH degree, and whether the scene is a
    2DGS surfel scene (two scale columns)."""
    if args.ply:
        from mojosplat_tpu_torch.utils.ply import load_gaussian_ply

        raw = params_from_numpy(load_gaussian_ply(args.ply), device)
    elif args.npz:
        from mojosplat_tpu_torch.utils.compress import load_compressed_scene

        raw = params_from_numpy(load_compressed_scene(args.npz), device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        raw = mtrain.init_gaussians(args.gaussians, sh_degree=None, position_scale=1.0,
                                    generator=gen, device=device)
    feats = raw["features"]
    sh_degree = int(round(feats.shape[1] ** 0.5)) - 1 if feats.ndim == 3 else None
    surfels = raw["scales"].shape[-1] == 2
    return raw, sh_degree, surfels


class Viewer:
    """The scene, its orbit and its renderer: ``png(az, el, r)`` is the
    ``/render`` handler's body, callable without a server."""

    def __init__(self, args, device: torch.device):
        raw, self.sh_degree, self.surfels = load_params(args, device)
        self.params = mtrain.activate(raw)
        self.device = device
        means = self.params["means3d"].cpu().numpy()
        self.center = means.mean(axis=0)
        extent = float(np.percentile(np.linalg.norm(means - self.center, axis=-1), 90))
        self.radius0 = max(2.5 * extent, 1e-2)
        self.H, self.W, self.focal = args.height, args.width, args.focal
        self.port = args.port
        self.config = RenderConfig(raster_impl=args.impl, tile_capacity=args.tile_capacity,
                                   chunk_size=64, pallas_chunk=128)
        self.page = (PAGE.replace("__W__", str(self.W)).replace("__H__", str(self.H))
                     .replace("__R__", f"{self.radius0:.4f}"))

    def camera_for(self, az: float, el: float, r: float) -> Camera:
        eye = self.center + r * np.array(
            [np.sin(az) * np.cos(el), np.sin(el), np.cos(az) * np.cos(el)])
        R, T = look_at(eye=np.asarray(eye, np.float32),
                       target=np.asarray(self.center, np.float32), up=[0.0, 1.0, 0.0],
                       device=self.device)
        return Camera.create(R=R, T=T, H=self.H, W=self.W, fx=self.focal, fy=self.focal,
                             cx=self.W / 2, cy=self.H / 2, device=self.device)

    def render(self, az: float, el: float, r: float) -> torch.Tensor:
        p = self.params
        prim = render_surfels if self.surfels else render_gaussians
        with torch.no_grad():
            return prim(p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"],
                        self.camera_for(az, el, r), sh_degree=self.sh_degree,
                        background_color=BACKGROUND, config=self.config)

    def png(self, az: float, el: float, r: float) -> bytes:
        return encode_png(to_uint8(self.render(az, el, r).cpu().numpy()))


def make_handler(viewer: Viewer):
    """The request handler class: ``/`` serves the page, ``/render`` a
    frame."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, kind: str):
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                self._send(viewer.page.encode(), "text/html")
                return
            if url.path == "/render":
                q = urllib.parse.parse_qs(url.query)
                az = float(q.get("az", [0.0])[0])
                el = float(q.get("el", [0.25])[0])
                r = float(q.get("r", [viewer.radius0])[0])
                self._send(viewer.png(az, el, r), "image/png")
                return
            self.send_response(404)
            self.end_headers()

    return Handler


def build_viewer(argv=None) -> Viewer:
    """Load the scene and render a first frame (which builds the kernel
    library on the card); returns the ``Viewer``."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    viewer = Viewer(args, dev)
    n = viewer.params["means3d"].shape[0]
    print(f"{n} {'surfels' if viewer.surfels else 'gaussians'} (SH degree "
          f"{viewer.sh_degree}); first frame at {viewer.W}x{viewer.H} on {dev} ...")
    t0 = time.perf_counter()
    viewer.png(0.0, 0.25, viewer.radius0)
    print(f"first frame in {time.perf_counter() - t0:.1f} s (the kernels are built; later "
          "frames reuse them)")
    return viewer


def main(argv=None) -> None:
    viewer = build_viewer(argv)
    srv = HTTPServer(("127.0.0.1", viewer.port), make_handler(viewer))
    print(f"viewer at http://localhost:{viewer.port}/  (ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
