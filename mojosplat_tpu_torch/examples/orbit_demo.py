"""Turntable orbit demo: render a camera orbit of a scene to PNG frames.

Port of ``examples/orbit_demo.py``. The kernels take the camera and the
image size as launch arguments, so every frame, and another image size,
reuses the one kernel library built at the first frame.

    python -m mojosplat_tpu_torch.examples.orbit_demo --frames 24
    python -m mojosplat_tpu_torch.examples.orbit_demo --ply scene.ply --gif

runs on the card through the CUDA kernels (``--device cuda --impl cuda``,
the defaults); ``--device cpu --impl torch`` on the CPU. Without ``--ply``
the cloud is drawn by ``train.init_gaussians`` from a ``torch.Generator``
seeded with 3 (the reference's PRNGKey(3)); the numbers differ from the
reference's draws.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_gaussians
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.utils import load_gaussian_ply, save_png, to_uint8

BACKGROUND = (0.05, 0.05, 0.08)
SEED = 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--gaussians", type=int, default=20_000)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--radius", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    ap.add_argument("--ply", default=None)
    ap.add_argument("--sh-degree", type=int, default=None)
    ap.add_argument("--out-dir", default="output/orbit")
    ap.add_argument("--gif", action="store_true",
                    help="also write an animated orbit.gif of the frames")
    return ap


def orbit_camera(angle: float, radius: float, H: int, W: int, f: float, *, device) -> Camera:
    """The camera at ``angle`` on the ring of ``radius`` at height
    0.3 x radius, looking at the origin."""
    eye = [radius * math.sin(angle), 0.3 * radius, radius * math.cos(angle)]
    R, T = look_at(eye=eye, target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0], device=device)
    return Camera.create(R=R, T=T, H=H, W=W, fx=f, fy=f, cx=W / 2, cy=H / 2, device=device)


def orbit_config(impl: str) -> RenderConfig:
    return RenderConfig(tile_batch=512, max_tile_span=32, tile_capacity=512, raster_impl=impl)


def load_scene(args, device) -> tuple[dict, int | None]:
    """The render parameters (the PLY's, or the seeded random cloud) and
    the SH degree."""
    sh_degree = args.sh_degree
    if args.ply:
        p = mtrain.activate(params_from_numpy(load_gaussian_ply(args.ply), device))
        if sh_degree is None:
            sh_degree = int(round(p["features"].shape[1] ** 0.5)) - 1
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        p = mtrain.activate(mtrain.init_gaussians(
            args.gaussians, position_scale=1.3, log_scale_mean=-2.4, generator=gen,
            device=device))
    return p, sh_degree


def render_frame(p: dict, cam: Camera, sh_degree, config: RenderConfig) -> torch.Tensor:
    with torch.no_grad():
        return render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                                p["features"], cam, sh_degree=sh_degree,
                                background_color=BACKGROUND, config=config)


def main(argv=None) -> dict:
    """Run the orbit on ``argv``; returns the per-frame times (render, host
    readback and PNG write) in milliseconds."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    if args.gif:
        import PIL  # noqa: F401  fail fast, before the rendering
    os.makedirs(args.out_dir, exist_ok=True)
    p, sh_degree = load_scene(args, dev)
    config = orbit_config(args.impl)

    frames, frame_ms = [], []
    for i in range(args.frames):
        t0 = time.perf_counter()
        cam = orbit_camera(2.0 * math.pi * i / args.frames, args.radius, args.height,
                           args.width, 0.7 * args.width, device=dev)
        img = render_frame(p, cam, sh_degree, config).cpu().numpy()
        save_png(img, os.path.join(args.out_dir, f"frame_{i:03d}.png"))
        if args.gif:
            frames.append(to_uint8(img))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    steady = float(np.mean(frame_ms[1:])) if len(frame_ms) > 1 else frame_ms[0]
    print(f"{args.frames} frames at {args.width}x{args.height}: first frame "
          f"{frame_ms[0] / 1e3:.1f}s (kernel build + first host readback), then "
          f"{steady:.0f} ms/frame ({1e3 / steady:.1f} fps incl. PNG IO; "
          f"one kernel library for all views)")
    if args.gif:
        from PIL import Image

        ims = [Image.fromarray(f) for f in frames]
        gif = os.path.join(args.out_dir, "orbit.gif")
        ims[0].save(gif, save_all=True, append_images=ims[1:], duration=80, loop=0)
        print(f"wrote {gif}")
    return dict(frame_ms=frame_ms, frames=args.frames)


if __name__ == "__main__":
    main()
