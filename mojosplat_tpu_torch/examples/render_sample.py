"""Demo: render a random gaussian cloud to a PNG.

Port of ``render_sample.py``, the reference demo's workload: 10k random
gaussians, 1920x1080, seed 42, camera at (0, 1.5, 5) looking at the origin,
dark-gray background.

    python -m mojosplat_tpu_torch.examples.render_sample [--gaussians 10000] \\
        [--out output/render_example.png]

runs on the card through the CUDA kernels (``--device cuda --impl cuda``,
the defaults); ``--device cpu --impl torch`` on the CPU. The random cloud
is drawn from a ``torch.Generator`` seeded with ``--seed``, with the
reference's distributions; the numbers differ from the reference's
``jax.random`` draws for the same seed.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_gaussians
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.utils import load_gaussian_ply, save_png

BACKGROUND = (0.1, 0.1, 0.1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaussians", type=int, default=10_000)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="output/render_example.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    ap.add_argument("--ply", default=None,
                    help="render a real 3DGS scene from a PLY file instead of the "
                    "random demo cloud")
    ap.add_argument("--sh-degree", type=int, default=None)
    ap.add_argument("--depth", action="store_true",
                    help="also save a normalized expected-depth map next to --out")
    return ap


def demo_camera(H: int, W: int, *, device) -> Camera:
    """The reference demo's pose and intrinsics: eye (0, 1.5, 5) -> origin,
    focal 500."""
    R, T = look_at(eye=[0.0, 1.5, 5.0], target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                   device=device)
    return Camera.create(R=R, T=T, H=H, W=W, fx=500.0, fy=500.0, cx=W / 2, cy=H / 2,
                         near=0.1, far=100.0, device=device)


def random_scene(n: int, seed: int, *, device) -> dict:
    """The demo cloud (render parameters): randn * 2 means, log-scales
    around -2, random unit quats, sigmoid(randn + 1) opacities, uniform
    RGB colours."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    means3d = randn(n, 3) * 2.0
    scales = -2.0 + randn(n, 3) * 0.3
    quats = randn(n, 4)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacities = torch.sigmoid(randn(n) + 1.0)
    colors = torch.rand((n, 3), generator=gen, device=device)
    return dict(means3d=means3d, scales=scales, quats=quats, opacities=opacities,
                features=colors)


def demo_config(impl: str) -> RenderConfig:
    """The random cloud has near-camera gaussians spanning hundreds of
    pixels: a generous tile-span budget (cheap at 10k gaussians)."""
    return RenderConfig(tile_batch=512, max_tile_span=64, tile_capacity=1024, raster_impl=impl)


def main(argv=None) -> dict:
    """Run the demo on ``argv``; returns the number of renders made and
    their times (seconds, each fenced on the device)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    camera = demo_camera(args.height, args.width, device=dev)

    sh_degree = args.sh_degree
    if args.ply is not None:
        print(f"Loading 3DGS scene from {args.ply}...")
        raw = load_gaussian_ply(args.ply)
        p = {k: torch.from_numpy(raw[k]).to(dev) for k in ("means3d", "scales", "quats",
                                                             "features")}
        p["opacities"] = torch.sigmoid(torch.from_numpy(raw["opacities_raw"]).to(dev))
        if sh_degree is None:
            sh_degree = int(round(p["features"].shape[1] ** 0.5)) - 1
        print(f"  {p['means3d'].shape[0]} gaussians, SH degree {sh_degree}")
    else:
        print(f"Generating {args.gaussians} random gaussians...")
        p = random_scene(args.gaussians, args.seed, device=dev)
    config = demo_config(args.impl)

    def render():
        with torch.no_grad():
            out = render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], camera,
                sh_degree=sh_degree, background_color=BACKGROUND, config=config,
                return_depth=args.depth, return_aux=args.depth)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out if args.depth else (out, None, None)

    print("Rendering (building the kernels on the first call)...")
    times = []
    for label in ("First render (incl. kernel build)", "Steady-state render"):
        t0 = time.perf_counter()
        image, depth, aux = render()
        times.append(time.perf_counter() - t0)
        print(f"{label}: {times[-1]:.3f}s")
    print(f"Rendered image shape: {tuple(image.shape)}")
    print(f"Rendered image range: [{float(image.min()):.4f}, {float(image.max()):.4f}]")

    print(f"Saving image to {args.out}...")
    save_png(image.cpu().numpy(), args.out)
    if args.depth:
        # Expected depth, alpha-masked, normalized to [0, 1] for viewing.
        alpha = 1.0 - aux.raster.final_transmittance
        edepth = depth / torch.clamp(alpha, min=1e-6)
        inf = torch.full_like(edepth, float("inf"))
        lo = torch.min(torch.where(alpha > 0.5, edepth, inf))
        hi = torch.max(torch.where(alpha > 0.5, edepth, -inf))
        vis = torch.clamp((edepth - lo) / torch.clamp(hi - lo, min=1e-6), 0, 1)
        vis = torch.where(alpha > 0.05, vis, torch.ones_like(vis))[..., None].repeat(1, 1, 3)
        depth_out = args.out.rsplit(".", 1)[0] + "_depth.png"
        save_png(vis.cpu().numpy(), depth_out)
        print(f"Saved depth map to {depth_out}")
    print("Done.")
    return dict(renders=len(times), seconds=times)


if __name__ == "__main__":
    main()
