"""Make a synthetic COLMAP capture: a structured gaussian scene rendered
from a ring of views.

Port of ``scripts/make_synth_colmap.py``. Builds a ground-truth scene of
about 150k gaussians (a floor sheet, coloured blob clusters and thin rods),
renders ``--views`` ring views of it and writes a standard COLMAP capture:

    <out>/images/view_###.png
    <out>/sparse/0/{cameras.bin, images.bin, points3D.bin}
    <out>/gt.ply

The sparse model holds a subsampled "SfM" cloud (ground-truth means and
colours) and each view's 2D observations of it, so ``train_colmap`` and
``eval_colmap`` run on it as on a real capture; ``resample_sfm`` rewrites
its cloud at another point count.

    python -m mojosplat_tpu_torch.examples.make_synth_colmap [--out output/synth_scene]

renders on the card through the CUDA kernels (``--device cuda --impl
cuda``, the defaults); ``--device cpu --impl torch`` on the CPU. The flags'
defaults read the variables MS_OUT, MS_H, MS_W, MS_NVIEWS, MS_NSFM, MS_NOBS
and MS_DETAIL, as the reference script does. Every draw comes from
``np.random.default_rng(7)`` in the reference's order (the scene, the SfM
subset, then one subset per view), so the scene, the cameras and the sparse
model are the reference's bit for bit. This is a tool for users: it writes
no benchmark file, and nothing reads its output as a metric.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mojosplat_tpu_torch import Camera, RenderConfig, render_gaussians
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.utils import colmap as cm
from mojosplat_tpu_torch.utils.colmap import rotmat_to_qvec
from mojosplat_tpu_torch.utils.image import save_png
from mojosplat_tpu_torch.utils.ply import save_gaussian_ply

SH = 3
C0 = 0.28209479177387814
# The ring's focal length as a share of the width.
FOCAL_PER_WIDTH = 0.72


def build_parser() -> argparse.ArgumentParser:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=env("MS_OUT", "output/synth_scene"))
    ap.add_argument("--height", type=int, default=int(env("MS_H", 512)))
    ap.add_argument("--width", type=int, default=int(env("MS_W", 512)))
    ap.add_argument("--views", type=int, default=int(env("MS_NVIEWS", 28)))
    ap.add_argument("--sfm-points", type=int, default=int(env("MS_NSFM", 30_000)))
    ap.add_argument("--obs-per-view", type=int, default=int(env("MS_NOBS", 1_500)),
                    help="2D observations drawn per view (those in frame are kept)")
    ap.add_argument("--detail", type=float, default=float(env("MS_DETAIL", 1.0)),
                    help="content richness scale (floor points, clusters, rods)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    return ap


def build_scene(rng: np.random.Generator, detail: float = 1.0) -> dict:
    """The structured ground truth: a floor, 60 blob clusters and 40 rods
    (x ``detail``), as float32 numpy render parameters (log-scales,
    unnormalised quaternions, opacities, SH degree-3 features with only the
    DC band set)."""
    parts = []

    def part(means, scales, colors, opac):
        n = means.shape[0]
        quats = rng.normal(size=(n, 4))
        parts.append((means, scales, quats, colors, np.full((n,), opac)))

    # Floor sheet at y = +1 (+Y down), checkered colour.
    n_f = round(40_000 * detail)
    fx = rng.uniform(-2.2, 2.2, n_f)
    fz = rng.uniform(-2.2, 2.2, n_f)
    fy = np.full(n_f, 1.0) + rng.normal(0, 0.01, n_f)
    checker = ((np.floor(fx * 2) + np.floor(fz * 2)) % 2)[:, None]
    fcol = np.where(checker > 0, [0.75, 0.72, 0.65], [0.35, 0.38, 0.45])
    fcol = fcol + rng.normal(0, 0.03, (n_f, 3))
    part(np.stack([fx, fy, fz], -1),
         np.exp(rng.normal(-3.4, 0.25, (n_f, 3))) * [1, 0.25, 1],
         fcol, 0.92)

    # Blob clusters.
    for _ in range(round(60 * detail)):
        n_c = rng.integers(1200, 2200)
        center = rng.uniform([-1.6, -0.4, -1.6], [1.6, 0.95, 1.6])
        radius = rng.uniform(0.08, 0.3)
        means = center + rng.normal(0, radius, (n_c, 3))
        base = rng.uniform(0.15, 0.95, 3)
        cols = np.clip(base + rng.normal(0, 0.08, (n_c, 3)), 0, 1)
        part(means, np.exp(rng.normal(-3.6, 0.3, (n_c, 3))), cols, 0.85)

    # Thin vertical rods (high-frequency structure for densification).
    for _ in range(round(40 * detail)):
        n_r = 500
        x0, z0 = rng.uniform(-1.8, 1.8, 2)
        y = np.linspace(-0.3, 1.0, n_r) + rng.normal(0, 0.004, n_r)
        means = np.stack([np.full(n_r, x0) + rng.normal(0, 0.008, n_r),
                          y,
                          np.full(n_r, z0) + rng.normal(0, 0.008, n_r)], -1)
        base = rng.uniform(0.2, 1.0, 3)
        part(means, np.exp(rng.normal(-4.2, 0.2, (n_r, 3))),
             np.clip(base + rng.normal(0, 0.05, (n_r, 3)), 0, 1), 0.9)

    means = np.concatenate([p[0] for p in parts]).astype(np.float32)
    scales = np.log(np.concatenate([p[1] for p in parts])).astype(np.float32)
    quats = np.concatenate([p[2] for p in parts]).astype(np.float32)
    cols = np.concatenate([p[3] for p in parts]).astype(np.float32)
    opac = np.concatenate([p[4] for p in parts]).astype(np.float32)
    feats = np.zeros((means.shape[0], 16, 3), np.float32)
    feats[:, 0, :] = (cols - 0.5) / C0
    return dict(means3d=means, scales=scales, quats=quats, opacities=opac, features=feats)


def ring_cameras(n_views: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(R, T) float32 world-to-camera poses on a ring about the scene,
    alternating radii 3.6 / 4.2 and three heights, each looking at (0, 0.4,
    0). The basis is proper (det +1, down = forward x right): ``look_at``'s
    [right; down; forward] stack has det -1, which renders the same but
    cannot be written as a COLMAP quaternion."""
    cams = []
    up = np.array([0.0, 1.0, 0.0])
    for i in range(n_views):
        ang = 2.0 * np.pi * i / n_views
        r = 3.6 if i % 2 == 0 else 4.2
        eye = np.array([r * np.sin(ang),
                        -0.4 - 0.5 * (i % 3) * 0.4,
                        r * np.cos(ang)], np.float64)
        forward = np.array([0.0, 0.4, 0.0]) - eye
        forward /= np.linalg.norm(forward)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R = np.stack([right, down, forward]).astype(np.float32)
        T = (-R @ eye).astype(np.float32)
        cams.append((R, T))
    return cams


def write_sparse(sparse: str, cams, fx: float, height: int, width: int, obs_per_view,
                 pts_xyz: np.ndarray, pts_rgb: np.ndarray) -> None:
    """The sparse model: one PINHOLE camera (fx = fy, centred principal
    point), one image per pose named view_###.png with its observations
    (xys, point ids), and the SfM cloud."""
    os.makedirs(sparse, exist_ok=True)
    cm.write_cameras_bin(os.path.join(sparse, "cameras.bin"),
                         [(1, 1, width, height, (fx, fx, width / 2, height / 2))])
    cm.write_images_bin(os.path.join(sparse, "images.bin"), [
        (i + 1, rotmat_to_qvec(R), T, 1, f"view_{i:03d}.png", xys, pids)
        for i, ((R, T), (xys, pids)) in enumerate(zip(cams, obs_per_view))])
    cm.write_points3d_bin(os.path.join(sparse, "points3D.bin"), pts_xyz, pts_rgb)


def render_config(impl: str) -> RenderConfig:
    """The maker's budgets (the reference script's)."""
    return RenderConfig(tile_capacity=512, chunk_size=64, tile_batch=512, max_tile_span=8,
                        raster_impl=impl)


def view_camera(R, T, height: int, width: int, *, device) -> Camera:
    fx = FOCAL_PER_WIDTH * width
    return Camera.create(R=R, T=T, H=height, W=width, fx=fx, fy=fx, cx=width / 2,
                         cy=height / 2, device=device)


def render_view(gt: dict, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """One view of the scene (device tensors) on a black background, the
    trainer's zero background."""
    with torch.no_grad():
        return render_gaussians(gt["means3d"], gt["scales"], gt["quats"], gt["opacities"],
                                gt["features"], camera, sh_degree=SH, config=config)


def main(argv=None) -> dict:
    """Make the capture; returns its counts, the qvec round trip's error and
    the seconds each view took (render and PNG, fenced on the device)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    H, W, out = args.height, args.width, args.out
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    gt = build_scene(rng, args.detail)
    n = gt["means3d"].shape[0]
    print(f"GT scene: {n} gaussians", flush=True)
    op = np.clip(gt["opacities"], 1e-4, 1 - 1e-4)
    save_gaussian_ply(os.path.join(out, "gt.ply"), {
        "means3d": gt["means3d"], "scales": gt["scales"], "quats": gt["quats"],
        "opacities_raw": np.log(op / (1 - op)).astype(np.float32),
        "features": gt["features"],
    })

    fx = FOCAL_PER_WIDTH * W
    cams = ring_cameras(args.views)
    config = render_config(args.impl)
    gt_dev = {k: torch.from_numpy(v).to(dev) for k, v in gt.items()}

    # "SfM" points: subsample the ground-truth means.
    sel = rng.choice(n, args.sfm_points, replace=False)
    pts_xyz = gt["means3d"][sel].astype(np.float64)
    pts_rgb = (np.clip(gt["features"][sel, 0, :] * C0 + 0.5, 0, 1) * 255).astype(np.uint8)

    obs_per_view, seconds = [], []
    for i, (R, T) in enumerate(cams):
        t0 = time.perf_counter()
        img = render_view(gt_dev, view_camera(R, T, H, W, device=dev), config)
        save_png(img.cpu().numpy(), os.path.join(out, "images", f"view_{i:03d}.png"))
        seconds.append(time.perf_counter() - t0)
        # Project a subset of the SfM points for this view's observations.
        osel = rng.choice(args.sfm_points, args.obs_per_view, replace=False)
        pc = pts_xyz[osel] @ R.T + T
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + W / 2
        v = fx * pc[:, 1] / np.maximum(z, 1e-6) + H / 2
        ok = (z > 0.2) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        obs_per_view.append((np.stack([u[ok], v[ok]], -1), osel[ok].astype(np.int64)))
        print(f"  view {i:02d}: rendered, {int(ok.sum())} obs", flush=True)

    sparse = os.path.join(out, "sparse", "0")
    write_sparse(sparse, cams, fx, H, W, obs_per_view, pts_xyz, pts_rgb)

    # Round trip through the loader.
    scene = cm.load_scene(sparse, with_points2d=True)
    if len(scene.images) != args.views or scene.points_xyz.shape[0] != args.sfm_points:
        raise RuntimeError(f"load_scene read {len(scene.images)} views and "
                           f"{scene.points_xyz.shape[0]} points back; wrote {args.views} and "
                           f"{args.sfm_points}")
    r_err = 0.0
    for im in scene.images:
        idx = int(im.name[5:8])  # view_###.png
        cam_i = scene.camera_for(im, 1, device="cpu")
        r_err = max(r_err, float(np.abs(cam_i.R.numpy() - cams[idx][0]).max()))
    print(f"load_scene round-trip OK; qvec->R max err {r_err:.2e}", flush=True)
    if not r_err < 1e-5:
        raise RuntimeError(f"load_scene round trip: qvec->R max err {r_err:.2e} >= 1e-5")
    return dict(gaussians=n, views=args.views, sfm_points=args.sfm_points,
                observations=[int(p.shape[0]) for _, p in obs_per_view], r_err=r_err,
                seconds=seconds)


if __name__ == "__main__":
    main()
