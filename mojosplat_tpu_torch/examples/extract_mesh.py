"""Extract a triangle mesh from a trained 2DGS surfel scene.

Port of ``examples/extract_mesh.py``, the 2DGS paper's reconstruction
(Huang et al. 2024, sec. 5): render per-view intersection depth maps of
the surfels on an orbit, fuse them into a TSDF volume on the device, and
extract the isosurface on the host (``utils.mesh``).

    python -m mojosplat_tpu_torch.examples.extract_mesh fitted_surfels.ply out_mesh.ply
    python -m mojosplat_tpu_torch.examples.extract_mesh fitted.ply out.obj --views 24 --res 256

runs on the card through the CUDA kernels (``--device cuda --impl cuda``,
the defaults: the depth maps come from the surfel blend with the maps, B7);
``--device cpu --impl torch`` on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_surfels
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.utils.mesh import (
    marching_tetrahedra,
    save_mesh_obj,
    save_mesh_ply,
    tsdf_fuse,
)
from mojosplat_tpu_torch.utils.ply import load_gaussian_ply


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="trained surfel scene (.ply, 2DGS layout)")
    ap.add_argument("dst", help="output mesh (.ply or .obj)")
    ap.add_argument("--views", type=int, default=16, help="orbit depth views to fuse")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--res", type=int, default=192, help="TSDF grid res")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    ap.add_argument("--elevations", type=float, nargs="+", default=[-0.2, 0.25, 0.6])
    ap.add_argument("--alpha-floor", type=float, default=0.5)
    ap.add_argument("--margin", type=float, default=0.1,
                    help="grid margin as a fraction of the scene extent")
    return ap


def mesh_config(impl: str) -> RenderConfig:
    return RenderConfig(raster_impl=impl, tile_capacity=512, chunk_size=64, pallas_chunk=128)


def depth_view(p: dict, cam: Camera, sh_degree, config: RenderConfig):
    """The expected (alpha-divided) intersection depth, 0 where alpha <=
    1e-3, and the alpha (1 - final transmittance) of one view."""
    with torch.no_grad():
        _, depth, aux = render_surfels(
            p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam,
            sh_degree=sh_degree, config=config, return_depth=True, return_aux=True)
    alpha = 1.0 - aux.raster.final_transmittance
    edepth = torch.where(alpha > 1e-3, depth / torch.clamp(alpha, min=1e-3),
                         torch.zeros_like(depth))
    return edepth, alpha


def orbit_cameras(center, radius: float, views: int, elevations, H: int, W: int, *,
                  device) -> list[Camera]:
    """``views // len(elevations)`` cameras on a ring at each elevation,
    the rings staggered, looking at ``center`` with focal 0.7 W."""
    focal = 0.7 * W
    cams = []
    n_az = max(1, views // len(elevations))
    for el in elevations:
        for i in range(n_az):
            az = 2.0 * np.pi * i / n_az + 0.5 * el  # stagger rings
            eye = center + radius * np.array(
                [np.sin(az) * np.cos(el), np.sin(el), np.cos(az) * np.cos(el)])
            R, T = look_at(eye=np.asarray(eye, np.float32),
                           target=np.asarray(center, np.float32), up=[0.0, 1.0, 0.0],
                           device=device)
            cams.append(Camera.create(R=R, T=T, H=H, W=W, fx=focal, fy=focal, cx=W / 2,
                                      cy=H / 2, device=device))
    return cams


def main(argv=None) -> dict:
    """Run the CLI on ``argv``. Returns the cameras, the depth and alpha
    maps (on the device), the grid bounds, the TSDF and its weights, the
    mesh, and each stage's seconds (``render``, ``fuse``, ``extract``;
    each fenced on the device)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    raw = load_gaussian_ply(args.src)
    p = mtrain.activate(params_from_numpy(raw, dev))
    feats = raw["features"]
    # PLY features are SH coefficients (K = (deg+1)^2 bases).
    sh_degree = None if feats.ndim == 2 else int(round(feats.shape[1] ** 0.5)) - 1
    means = np.asarray(raw["means3d"])
    center = means.mean(axis=0)
    extent = float(np.percentile(np.linalg.norm(means - center, axis=-1), 95))
    lo = center - (1.0 + args.margin) * extent
    hi = center + (1.0 + args.margin) * extent
    config = mesh_config(args.impl)

    times = {}
    t0 = time.perf_counter()
    cams = orbit_cameras(center, 2.6 * extent, args.views, args.elevations, args.height,
                         args.width, device=dev)
    depths, alphas = [], []
    for cam in cams:
        ed, al = depth_view(p, cam, sh_degree, config)
        depths.append(ed)
        alphas.append(al)
    sync()
    times["render"] = time.perf_counter() - t0
    print(f"rendered {len(cams)} depth views in {times['render']:.1f} s")

    t0 = time.perf_counter()
    tsdf, w, origin, spacing = tsdf_fuse(depths, alphas, cams, (lo, hi),
                                         resolution=args.res, alpha_floor=args.alpha_floor)
    times["fuse"] = time.perf_counter() - t0
    observed = float((w > 0).mean())
    print(f"fused TSDF {args.res}^3 in {times['fuse']:.1f} s ({observed * 100:.1f}% observed)")

    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra(tsdf, origin=origin, spacing=spacing, mask=w > 0)
    times["extract"] = time.perf_counter() - t0
    print(f"extracted {len(verts)} verts / {len(faces)} faces in {times['extract']:.1f} s")

    if args.dst.endswith(".obj"):
        save_mesh_obj(args.dst, verts, faces)
    else:
        save_mesh_ply(args.dst, verts, faces)
    print(f"wrote {args.dst}")
    return dict(cameras=cams, depths=depths, alphas=alphas, bounds=(lo, hi), tsdf=tsdf,
                weight=w, origin=origin, spacing=spacing, verts=verts, faces=faces,
                times=times, observed=observed)


if __name__ == "__main__":
    main()
