"""End-to-end 2DGS (surfel) training demo.

Port of ``examples/train_surfel_demo.py``: fits a cloud of 2D gaussian
surfels to rendered target views with a photometric loss plus the 2DGS
paper's normal-consistency and depth-distortion regularizers, each view's
loss ``mean((img - target)^2) + normal_weight * normal_consistency_loss +
distortion_weight * mean(distortion)`` averaged over the views.

    python -m mojosplat_tpu_torch.examples.train_surfel_demo --steps 200

runs on the card through the CUDA kernels (``--device cuda --impl cuda``,
the defaults: the surfel blend with the maps B7 and its backward B8);
``--device cpu --impl torch`` on the CPU.

The reference runs ``--steps-per-call`` steps in one ``lax.scan``; here
every step is its own call and ``--steps-per-call`` is the cadence of the
loss lines; the run takes exactly ``--steps`` steps. The surfels are
drawn from ``torch.Generator``s seeded as the reference's keys (1 and 42);
the numbers differ from the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_surfels
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.examples.train_colmap import _leaves, resolve_device
from mojosplat_tpu_torch.surfel import normal_consistency_loss
from mojosplat_tpu_torch.utils import save_gaussian_ply, save_png

GT_SEED, FIT_SEED = 1, 42


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-surfels", type=int, default=2000)
    ap.add_argument("--fit-surfels", type=int, default=2000)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--normal-weight", type=float, default=0.01)
    ap.add_argument("--distortion-weight", type=float, default=0.001,
                    help="2DGS depth-distortion regularizer weight")
    ap.add_argument("--steps-per-call", type=int, default=25,
                    help="steps between two loss lines")
    ap.add_argument("--out-dir", default="output/train_surfel_demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the surfel kernels (the maps' variant renders the "
                    "depth/normal/distortion maps the regularizers need); 'torch': the "
                    "plain route, with the same loss")
    return ap


def surfels_from_draws(z_means, z_scales, z_quats, z_opac, u_feat, position_scale: float):
    """The raw surfel parameters from standard-normal draws (means (n, 3),
    scales (n, 2), quats (n, 4), opacities (n,)) and uniform colours (n, 3):
    means scaled by ``position_scale``, log-scales around -2.3 (a disk),
    unit quats, logits around 1."""
    return dict(
        means3d=z_means * position_scale,
        scales=-2.3 + z_scales * 0.3,  # (N, 2): a disk
        quats=z_quats / torch.linalg.norm(z_quats, dim=-1, keepdim=True),
        opacities_raw=z_opac + 1.0,
        features=u_feat,
    )


def init_surfels(n: int, position_scale: float = 1.0, *, generator: torch.Generator,
                 device) -> dict:
    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    z_means, z_scales, z_quats, z_opac = randn(n, 3), randn(n, 2), randn(n, 4), randn(n)
    u_feat = torch.rand((n, 3), generator=generator, device=device)
    return surfels_from_draws(z_means, z_scales, z_quats, z_opac, u_feat, position_scale)


def make_cameras(views: int, H: int, W: int, *, device) -> list[Camera]:
    """``views`` cameras on a ring of radius 3 at height 0.8, focal 0.9 W
    (the reference's angle step uses 3.14159)."""
    cams = []
    for i in range(views):
        angle = 2.0 * 3.14159 * i / views
        eye = [3.0 * math.sin(angle), 0.8, 3.0 * math.cos(angle)]
        R, T = look_at(eye=eye, target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0], device=device)
        cams.append(Camera.create(R=R, T=T, H=H, W=W, fx=0.9 * W, fy=0.9 * W, cx=W / 2,
                                  cy=H / 2, device=device))
    return cams


def render_batch(p: dict, cams, config: RenderConfig) -> torch.Tensor:
    with torch.no_grad():
        return torch.stack([
            render_surfels(p["means3d"], p["scales"], p["quats"], p["opacities"],
                           p["features"], cam, config=config) for cam in cams])


def surfel_demo_loss(params: dict, cams, targets, config: RenderConfig,
                     normal_weight: float, distortion_weight: float) -> torch.Tensor:
    p = mtrain.activate(params)
    loss = 0.0
    for cam, tgt in zip(cams, targets):
        img, depth, normal, dist, aux = render_surfels(
            p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam,
            config=config, return_aux=True, return_depth=True, return_normals=True,
            return_distortion=True)
        photo = torch.mean((img - tgt) ** 2)
        reg = normal_consistency_loss(depth, normal, aux.raster.final_transmittance, cam)
        loss = loss + (photo + normal_weight * reg + distortion_weight * torch.mean(dist))
    return loss / len(cams)


def main(argv=None, on_step=None) -> dict:
    """Run the demo on ``argv``; ``on_step(step, loss)`` is called after
    every step. Returns the initial and final PSNR and the losses."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    os.makedirs(args.out_dir, exist_ok=True)
    H, W = args.height, args.width
    config = RenderConfig(tile_capacity=256, chunk_size=32, raster_impl=args.impl)
    cams = make_cameras(args.views, H, W, device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(GT_SEED)
    gt = mtrain.activate(init_surfels(args.gt_surfels, 0.8, generator=gen, device=dev))
    targets = render_batch(gt, cams, config)
    print(f"Rendered {args.views} target views at {W}x{H}")

    gen.manual_seed(FIT_SEED)
    params = _leaves(init_surfels(args.fit_surfels, 1.0, generator=gen, device=dev))
    optimizer = mtrain.make_optimizer(params, args.lr)

    img0 = render_batch(mtrain.activate(params), cams, config)
    psnr0 = float(mtrain.psnr(img0, targets))
    print(f"initial PSNR: {psnr0:.2f} dB")

    t0 = time.perf_counter()
    losses = []
    for step in range(args.steps):
        optimizer.zero_grad(set_to_none=True)
        loss = surfel_demo_loss(params, cams, targets, config, args.normal_weight,
                                args.distortion_weight)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
        done = step + 1
        if done % args.steps_per_call == 0 or done == args.steps:
            print(f"step {done:5d}  loss {float(losses[-1]):.6f}  "
                  f"({(time.perf_counter() - t0) / done * 1000:.1f} ms/step avg)", flush=True)
        if on_step is not None:
            on_step(step, loss)

    img1 = render_batch(mtrain.activate(params), cams, config)
    final_psnr = float(mtrain.psnr(img1, targets))
    print(f"final PSNR: {final_psnr:.2f} dB after {args.steps} steps")
    save_png(img1[0].cpu().numpy(), os.path.join(args.out_dir, "after.png"))
    save_png(targets[0].cpu().numpy(), os.path.join(args.out_dir, "target.png"))
    ply = os.path.join(args.out_dir, "fitted_surfels.ply")
    save_gaussian_ply(ply, params)
    print(f"Saved fitted surfel scene to {ply} (2DGS two-scale layout)")
    return dict(initial_psnr=psnr0, final_psnr=final_psnr, losses=[float(x) for x in losses])


if __name__ == "__main__":
    main()
