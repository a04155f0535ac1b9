"""Evaluate a trained scene against a COLMAP capture's views.

Port of ``examples/eval_colmap.py`` to PyTorch: load a scene PLY (e.g.
``train_colmap``'s ``scene_final.ply``; two scale columns make it a 2DGS
scene), render every Nth view and report per-view and mean PSNR / SSIM,
the summary as one JSON line, last.

    python -m mojosplat_tpu_torch.examples.eval_colmap --data /path/to/capture \\
        --ply output/train_colmap/scene_final.ply --downscale 4 --every 8

runs on the card through the CUDA kernels (the defaults); ``--device cpu
--impl torch`` runs on the CPU. ``--appearance-opt affine|bilagrid`` fits
a per-view correction on the left half of each ground-truth image with
Adam and scores the right half, corrected and raw (the NeRF-W protocol).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mojosplat_tpu_torch import (
    RenderConfig,
    apply_bilateral_grid,
    bilateral_grid_tv,
    identity_bilateral_grid,
    render_gaussians,
    render_surfels,
)
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.examples.train_colmap import load_view_images, resolve_device
from mojosplat_tpu_torch.utils import colmap as cm
from mojosplat_tpu_torch.utils.image import save_png
from mojosplat_tpu_torch.utils.ply import load_gaussian_ply


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="capture root (INRIA layout)")
    ap.add_argument("--ply", required=True, help="trained scene PLY")
    ap.add_argument("--sparse", default=None)
    ap.add_argument("--downscale", type=int, default=4)
    ap.add_argument("--every", type=int, default=8,
                    help="evaluate every Nth view (8 = the Mip-NeRF-360 test split)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"])
    ap.add_argument("--tile-capacity", type=int, default=512)
    ap.add_argument("--save-renders", default=None,
                    help="directory to dump rendered test views")
    ap.add_argument("--appearance-opt", default="none",
                    choices=["none", "affine", "bilagrid"],
                    help="test-time appearance fit: a 3x4 affine or a bilateral grid "
                    "fitted on the left half of each ground truth, metrics on the "
                    "right half (corrected and raw)")
    ap.add_argument("--appearance-steps", type=int, default=100)
    ap.add_argument("--appearance-lr", type=float, default=5e-3)
    ap.add_argument("--appearance-tv", type=float, default=10.0,
                    help="bilateral-grid TV weight during the test-time fit")
    return ap


def fit_and_correct(img: torch.Tensor, tgt: torch.Tensor, app: str, steps: int, lr: float,
                    tv: float) -> torch.Tensor:
    """``img`` corrected by an affine (``app="affine"``) or a bilateral
    grid fitted with ``steps`` Adam steps to ``tgt`` on the left half of
    the image only (full-image coordinates, so the grid's spatial axes stay
    aligned; a masked per-pixel mean)."""
    def correct(a):
        return mtrain.apply_exposure(img, a) if app == "affine" else apply_bilateral_grid(img, a)

    dev = img.device
    a = (mtrain.identity_exposure(1, device=dev)[0] if app == "affine"
         else identity_bilateral_grid(1, device=dev)[0]).requires_grad_(True)
    h, w, c = img.shape
    left = (torch.arange(w, device=dev) < w // 2).to(img.dtype)[None, :, None]
    opt = torch.optim.Adam([a], lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = ((correct(a) - tgt) ** 2 * left).sum() / (h * (w // 2) * c)
        if app == "bilagrid":
            loss = loss + tv * bilateral_grid_tv(a[None])
        loss.backward()
        opt.step()
    with torch.no_grad():
        return correct(a)


def main(argv=None) -> dict:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns the
    summary it prints, with the per-view rows under ``"rows"``."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sparse = args.sparse or os.path.join(args.data, "sparse", "0")
    scene = cm.load_scene(sparse)
    views, images = load_view_images(args.data, scene, args.downscale)
    views, images = views[::args.every], images[::args.every]
    if not views:
        raise SystemExit("no views selected")
    H, W = images[0].shape[:2]

    params = mtrain.activate(params_from_numpy(load_gaussian_ply(args.ply), dev))
    sh_degree = int(round(params["features"].shape[1] ** 0.5)) - 1
    surfels = params["scales"].shape[-1] == 2  # the 2DGS PLY layout
    print(f"{params['means3d'].shape[0]} gaussians, SH degree {sh_degree}; "
          f"{len(views)} test views at {W}x{H}")
    config = RenderConfig(tile_capacity=args.tile_capacity, chunk_size=64, max_tile_span=8,
                          tile_batch=512, raster_impl=args.impl)
    render_fn = render_surfels if surfels else render_gaussians
    if args.save_renders:
        os.makedirs(args.save_renders, exist_ok=True)

    app = args.appearance_opt
    rows = []
    for v, target in zip(views, images):
        cam = scene.camera_for(v, args.downscale, device=dev)
        with torch.no_grad():
            img = render_fn(params["means3d"], params["scales"], params["quats"],
                            params["opacities"], params["features"], cam,
                            sh_degree=sh_degree, config=config)
        tgt = torch.from_numpy(target).to(dev)
        row = {"view": v.name, "psnr": float(mtrain.psnr(img, tgt)),
               "ssim": float(mtrain.ssim(img, tgt))}
        if app != "none":
            fixed = fit_and_correct(img, tgt, app, args.appearance_steps, args.appearance_lr,
                                    args.appearance_tv)
            half = tgt.shape[1] // 2
            row["psnr_right_corrected"] = float(mtrain.psnr(fixed[:, half:], tgt[:, half:]))
            row["psnr_right_raw"] = float(mtrain.psnr(img[:, half:], tgt[:, half:]))
        rows.append(row)
        extra = (f"  corrected-right {row['psnr_right_corrected']:6.2f}"
                 if app != "none" else "")
        print(f"  {row['view']:>24}  PSNR {row['psnr']:6.2f}  SSIM {row['ssim']:.4f}{extra}")
        if args.save_renders:
            save_png(img.cpu().numpy(), os.path.join(
                args.save_renders, os.path.basename(v.name) + ".render.png"))

    summary = {
        "views": len(rows),
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
        "mean_ssim": float(np.mean([r["ssim"] for r in rows])),
    }
    if app != "none":
        for key in ("psnr_right_corrected", "psnr_right_raw"):
            summary[f"mean_{key}"] = float(np.mean([r[key] for r in rows]))
    print(json.dumps(summary))
    return dict(summary, rows=rows)


if __name__ == "__main__":
    main()
