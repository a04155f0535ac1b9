"""Resample a synthetic capture's SfM model at another point count.

Port of ``scripts/resample_sfm.py``. Rewrites ``<root>/sparse/0``
(``points3D.bin`` and the per-image 2D observations in ``images.bin``)
from the capture's ground-truth PLY (``<root>/gt.ply``, as
``make_synth_colmap`` writes it) at ``--sfm-points`` points, leaving the
images untouched. More points than the scene holds are drawn with
replacement and jittered: this is how a fixed-capacity trainer is seeded
at 1M points.

    python -m mojosplat_tpu_torch.examples.resample_sfm --root output/synth_scene \\
        --sfm-points 1000000

Host only (numpy and the port's PLY and COLMAP IO); no device is used. The
flags' defaults read MS_ROOT, MS_NSFM and MS_NOBS, as the reference script
does, and the draws come from ``np.random.default_rng(11)`` in its order,
so the files are the reference's byte for byte. The new model is written
to a staging directory, read back, and only then swapped into place. This
is a tool for users: it writes no benchmark file, and nothing reads its
output as a metric.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from mojosplat_tpu_torch.utils import colmap as cm
from mojosplat_tpu_torch.utils.ply import load_gaussian_ply

C0 = 0.28209479177387814


def build_parser() -> argparse.ArgumentParser:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=env("MS_ROOT", "output/synth_scene"),
                    help="capture root holding gt.ply and sparse/0")
    ap.add_argument("--sfm-points", type=int, default=int(env("MS_NSFM", 110_000)))
    ap.add_argument("--obs-per-view", type=int, default=int(env("MS_NOBS", 4_000)),
                    help="2D observations drawn per view (those in frame are kept)")
    return ap


def main(argv=None) -> dict:
    """Rewrite the sparse model; returns the counts written."""
    args = build_parser().parse_args(argv)
    n_sfm, n_obs = args.sfm_points, args.obs_per_view
    sparse = os.path.join(args.root, "sparse", "0")
    rng = np.random.default_rng(11)
    scene = cm.load_scene(sparse)
    # The full intrinsics of the COLMAP record (a real capture's fy, cx, cy
    # need not be fx, W / 2, H / 2).
    fx, fy, cx, cy, W, H, _dist, _model = cm.camera_intrinsics(scene.cameras[1])

    ply = load_gaussian_ply(os.path.join(args.root, "gt.ply"))
    means = np.asarray(ply["means3d"], np.float64)
    rgb = (np.clip(ply["features"][:, 0, :] * C0 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)
    # With replacement (and a small jitter) past the scene's own count.
    replace = n_sfm > means.shape[0]
    sel = rng.choice(means.shape[0], n_sfm, replace=replace)
    pts_xyz, pts_rgb = means[sel].copy(), rgb[sel]
    if replace:
        pts_xyz += rng.normal(0, 0.01, pts_xyz.shape)

    images = sorted(scene.images, key=lambda im: im.name)
    records = []
    for im in images:
        R = cm.qvec_to_rotmat(im.qvec)
        osel = rng.choice(n_sfm, n_obs, replace=False)
        pc = pts_xyz[osel] @ R.T + np.asarray(im.tvec)
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * pc[:, 1] / np.maximum(z, 1e-6) + cy
        ok = (z > 0.2) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        records.append((im.image_id, cm.rotmat_to_qvec(R), im.tvec, im.camera_id, im.name,
                        np.stack([u[ok], v[ok]], -1), osel[ok].astype(np.int64)))

    # Write and read back in a staging directory, then swap both files into
    # place: a write that failed halfway would otherwise truncate the only
    # copy of the model.
    stage = os.path.join(args.root, "sparse", "_stage")
    os.makedirs(stage, exist_ok=True)
    try:
        shutil.copyfile(os.path.join(sparse, "cameras.bin"), os.path.join(stage, "cameras.bin"))
        cm.write_images_bin(os.path.join(stage, "images.bin"), records)
        cm.write_points3d_bin(os.path.join(stage, "points3D.bin"), pts_xyz, pts_rgb)
        check = cm.load_scene(stage, with_points2d=True)
        if check.points_xyz.shape[0] != n_sfm or len(check.images) != len(images):
            raise RuntimeError(f"read back {check.points_xyz.shape[0]} points and "
                               f"{len(check.images)} views; wrote {n_sfm} and {len(images)}")
        n_written = sum(im.point3d_ids.shape[0] for im in check.images
                        if im.point3d_ids is not None)
        for name in ("images.bin", "points3D.bin"):
            os.replace(os.path.join(stage, name), os.path.join(sparse, name))
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    print(f"rewrote sparse model: {n_sfm} points, {n_written} observations over "
          f"{len(images)} views", flush=True)
    return dict(points=n_sfm, observations=n_written, views=len(images), replace=replace)


if __name__ == "__main__":
    main()
