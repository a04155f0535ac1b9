"""Shared cases of the port's scene-tool tests (a helper module, no tests).

Numpy only, no JAX, so the card tests and ``chip_smoke.py`` import it too:

  - ``sphere_sdf``: the analytic sphere field of tests/test_mesh.py;
  - ``surfel_sphere``: tests/test_mesh.py's surfels tiling a sphere of
    radius 0.8, as numpy render parameters;
  - ``reconstruct_sphere``: tests/test_mesh.py's end-to-end
    reconstruction of that sphere (12 depth views at 96x96, a 64^3 TSDF,
    marching tetrahedra) through the port on a chosen route and device,
    with the test's bounds on the vertices' radius error;
  - ``write_blender_split``: a NeRF-synthetic transforms split of RGBA
    frames at given world-to-camera poses;
  - ``ring_poses``: look-at poses on a ring about the origin.
"""

from __future__ import annotations

import json
import os

import numpy as np

SPHERE_R = 0.8
# tests/test_mesh.py:156-157: the reconstructed vertices' radius error in
# voxel spacings, median and 90th percentile.
SPHERE_MEDIAN_VOXELS, SPHERE_P90_VOXELS = 2.1, 3.0


def sphere_sdf(n=40, r=SPHERE_R, extent=1.2):
    ax = np.linspace(-extent, extent, n).astype(np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sp = ax[1] - ax[0]
    return (np.sqrt(X**2 + Y**2 + Z**2) - r, (-extent,) * 3, (sp,) * 3)


def surfel_sphere(n_lat=24, n_lon=48, r=SPHERE_R) -> dict:
    """Surfels tiling a sphere, tangent frames aligned to the surface:
    render parameters (opacities, RGB features) as float32 numpy."""
    thetas = np.linspace(0.15, np.pi - 0.15, n_lat)
    params = {"means3d": [], "quats": [], "scales": [], "opacities": [], "features": []}
    for th in thetas:
        for ph in np.linspace(0, 2 * np.pi, n_lon, endpoint=False):
            nrm = np.array([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)])
            up = np.array([0.0, 1.0, 0.0])
            tu = np.cross(up, nrm)
            tu /= max(np.linalg.norm(tu), 1e-9)
            tv = np.cross(nrm, tu)
            # Rotation with columns [t_u, t_v, n] -> wxyz quaternion.
            M = np.stack([tu, tv, nrm], axis=1)
            w = np.sqrt(max(1.0 + M[0, 0] + M[1, 1] + M[2, 2], 1e-9)) / 2
            x = (M[2, 1] - M[1, 2]) / (4 * w)
            y = (M[0, 2] - M[2, 0]) / (4 * w)
            z = (M[1, 0] - M[0, 1]) / (4 * w)
            params["means3d"].append(r * nrm)
            params["quats"].append([w, x, y, z])
            params["scales"].append([np.log(0.09), np.log(0.09)])
            params["opacities"].append(0.98)
            params["features"].append([0.8, 0.6, 0.4])
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def sphere_cameras(device, H=96, W=96, focal=70.0) -> list:
    """tests/test_mesh.py's 12 views: 4 azimuths at each of 3 elevations,
    radius 2.6, looking at the origin."""
    from mojosplat_tpu_torch import Camera, look_at

    cams = []
    for el in (-0.35, 0.0, 0.35):
        for i in range(4):
            az = 2 * np.pi * i / 4 + el
            eye = 2.6 * np.array([np.sin(az) * np.cos(el), np.sin(el), np.cos(az) * np.cos(el)])
            R, T = look_at(eye=eye.astype(np.float32), target=[0.0, 0.0, 0.0],
                           up=[0.0, 1.0, 0.0], device=device)
            cams.append(Camera.create(R=R, T=T, H=H, W=W, fx=focal, fy=focal, cx=W / 2,
                                      cy=H / 2, device=device))
    return cams


def reconstruct_sphere(impl: str, device, res: int = 64) -> dict:
    """The sphere's reconstruction through ``examples.extract_mesh.depth_view``
    on route ``impl``, ``utils.mesh.tsdf_fuse`` on ``device`` and
    ``marching_tetrahedra``. Returns the mesh, the observed share, and the
    radius error's median and 90th percentile in voxel spacings."""
    from mojosplat_tpu_torch import RenderConfig
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.examples.extract_mesh import depth_view
    from mojosplat_tpu_torch.utils.mesh import marching_tetrahedra, tsdf_fuse

    p = params_from_numpy(surfel_sphere(), device)
    cfg = RenderConfig(tile_capacity=256, chunk_size=64, raster_impl=impl)
    cams = sphere_cameras(device)
    depths, alphas = zip(*(depth_view(p, cam, None, cfg) for cam in cams))
    tsdf, w, origin, spacing = tsdf_fuse(depths, alphas, cams, ((-1.1,) * 3, (1.1,) * 3),
                                         resolution=res)
    verts, faces = marching_tetrahedra(tsdf, origin=origin, spacing=spacing, mask=w > 0)
    rad = np.linalg.norm(verts, axis=-1)
    sp = float(spacing[0])
    return dict(verts=verts, faces=faces, observed=float((w > 0).mean()), spacing=sp,
                median_voxels=abs(float(np.median(rad)) - SPHERE_R) / sp,
                p90_voxels=float(np.percentile(np.abs(rad - SPHERE_R), 90)) / sp)


def ring_poses(n: int, radius: float, height: float) -> list:
    """World-to-camera (R, T) of ``n`` look-at cameras on a ring about the
    origin (+X right, +Y down, +Z forward), as float32 numpy."""
    poses = []
    for i in range(n):
        ang = 2.0 * np.pi * i / n
        eye = np.array([radius * np.sin(ang), height, radius * np.cos(ang)], np.float32)
        forward = -eye / np.linalg.norm(eye)
        right = np.cross(forward, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(right, forward)
        R = np.stack([right, down, forward]).astype(np.float32)
        poses.append((R, (-R @ eye).astype(np.float32)))
    return poses


def write_blender_split(root: str, split: str, poses, frames, angle_x: float) -> None:
    """``transforms_<split>.json`` and one RGBA PNG per pose (``frames``: a
    list of (H, W, 4) uint8 arrays) under ``root``; the poses are
    world-to-camera (R, T), written as OpenGL camera-to-world matrices.
    The PNGs go through the port's native writer (stored deflate) where it
    builds, else ``encode_png``."""
    from mojosplat_tpu_torch.native import get_native
    from mojosplat_tpu_torch.utils.image import encode_png

    native = get_native()
    flip = np.diag([1.0, -1.0, -1.0])
    entries = []
    for i, ((R, T), rgba) in enumerate(zip(poses, frames)):
        name = f"{split}/r_{i}"
        os.makedirs(os.path.join(root, split), exist_ok=True)
        path = os.path.join(root, name + ".png")
        if native is not None:
            native.write_png(path, *rgba.shape, np.ascontiguousarray(rgba).tobytes())
        else:
            with open(path, "wb") as f:
                f.write(encode_png(rgba))
        c2w = np.eye(4)
        c2w[:3, :3] = np.asarray(R, np.float64).T @ flip
        c2w[:3, 3] = -np.asarray(R, np.float64).T @ np.asarray(T, np.float64)
        entries.append({"file_path": f"./{name}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": angle_x, "frames": entries}, f)


def half_red_frame(H: int, W: int) -> np.ndarray:
    """tests/test_blender.py's frame: red, the top half opaque and the
    bottom transparent."""
    rgba = np.zeros((H, W, 4), np.uint8)
    rgba[..., 0] = 200
    rgba[: H // 2, :, 3] = 255
    return rgba

