"""COLMAP sparse-reconstruction loading and 3DGS scene initialization.

Port of ``mojosplat_tpu.utils.colmap`` (numpy only, bit-equal to it). A
COLMAP capture (``sparse/0`` with ``cameras.bin`` / ``images.bin`` /
``points3D.bin`` beside an ``images/`` directory) is parsed by the native C
runtime (``native/io_native.c``) when it builds and by the pure-Python
``struct`` readers below otherwise; COLMAP's world-to-camera (qvec, tvec)
pose becomes the port's :class:`Camera` (COLMAP and gsplat share the +X
right, +Y down, +Z forward convention); and the SfM point cloud seeds the
standard 3DGS parameters (means at the points, SH DC from the point
colours, log-scales from the mean nearest-neighbour distance, opacity
logits at 0.1).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..native import get_native
from ..ops.sh import num_sh_bases

# COLMAP camera-model parameter counts, by model id.
_MODEL_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4,
                 9: 5, 10: 12}
# Models whose leading params are (f|fx fy) cx cy (we ignore distortion
# terms beyond those — 3DGS assumes undistorted inputs).
_SINGLE_FOCAL = {0, 2, 3, 7, 8, 9}


@dataclass
class ColmapCamera:
    camera_id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray  # (num_params,) float64


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz, world-to-camera rotation
    tvec: np.ndarray  # (3,) world-to-camera translation
    camera_id: int
    name: str
    # 2D keypoint observations (load_scene(with_points2d=True) only):
    xys: np.ndarray | None = None  # (n_obs, 2) pixel coords, full-res
    point3d_ids: np.ndarray | None = None  # (n_obs,) int64, -1 = untracked


def _read_cameras_python(path: str) -> list[ColmapCamera]:
    out = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id = struct.unpack("<ii", f.read(8))
            width, height = struct.unpack("<QQ", f.read(16))
            np_ = _MODEL_PARAMS.get(model_id)
            if np_ is None:
                raise ValueError(f"{path}: unknown camera model {model_id}")
            params = np.frombuffer(f.read(8 * np_), dtype="<f8")
            out.append(ColmapCamera(cam_id, model_id, width, height, params))
    return out


def _read_images_python(
    path: str, with_points2d: bool = False
) -> list[ColmapImage]:
    out = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (image_id,) = struct.unpack("<i", f.read(4))
            qvec = np.frombuffer(f.read(32), dtype="<f8").copy()
            tvec = np.frombuffer(f.read(24), dtype="<f8").copy()
            (camera_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c in (b"", b"\x00"):
                    break
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            xys = p3d = None
            if with_points2d and npts:
                # Each record: x (f8), y (f8), point3D_id (i8).
                rec = np.frombuffer(f.read(npts * 24), dtype="<f8")
                rec = rec.reshape(npts, 3)
                xys = rec[:, :2].astype(np.float32)
                p3d = np.ascontiguousarray(rec[:, 2]).view("<i8")
            else:
                f.seek(npts * 24, os.SEEK_CUR)
            out.append(
                ColmapImage(image_id, qvec, tvec, camera_id,
                            name.decode("utf-8", "replace"),
                            xys=xys, point3d_ids=p3d)
            )
    return out


def _read_points_python(
    path: str, with_ids: bool = False
):
    xyzs, rgbs, ids = [], [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (pid,) = struct.unpack("<Q", f.read(8))
            xyzs.append(np.frombuffer(f.read(24), dtype="<f8").copy())
            rgbs.append(np.frombuffer(f.read(3), dtype=np.uint8).copy())
            f.read(8)  # reprojection error
            (track,) = struct.unpack("<Q", f.read(8))
            f.seek(track * 8, os.SEEK_CUR)
            ids.append(pid)
    if not xyzs:
        out = (np.zeros((0, 3)), np.zeros((0, 3), np.uint8))
    else:
        out = (np.stack(xyzs), np.stack(rgbs))
    if with_ids:
        return out + (np.asarray(ids, np.int64),)
    return out


def read_cameras_bin(path: str) -> list[ColmapCamera]:
    nat = get_native()
    if nat is None or not hasattr(nat, "load_colmap_cameras"):
        return _read_cameras_python(path)
    return [
        ColmapCamera(cid, mid, w, h, np.frombuffer(p, dtype="<f8"))
        for cid, mid, w, h, p in nat.load_colmap_cameras(path)
    ]


def read_images_bin(path: str) -> list[ColmapImage]:
    nat = get_native()
    if nat is None or not hasattr(nat, "load_colmap_images"):
        return _read_images_python(path)
    n, ids, qvecs, tvecs, cam_ids, names = nat.load_colmap_images(path)
    ids = np.frombuffer(ids, dtype="<i4")
    qvecs = np.frombuffer(qvecs, dtype="<f8").reshape(n, 4)
    tvecs = np.frombuffer(tvecs, dtype="<f8").reshape(n, 3)
    cam_ids = np.frombuffer(cam_ids, dtype="<i4")
    return [
        ColmapImage(int(ids[i]), qvecs[i].copy(), tvecs[i].copy(),
                    int(cam_ids[i]), names[i])
        for i in range(n)
    ]


def read_points3d_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(xyz (P,3) f64, rgb (P,3) u8) of the sparse SfM point cloud."""
    nat = get_native()
    if nat is None or not hasattr(nat, "load_colmap_points"):
        return _read_points_python(path)
    n, xyz, rgb = nat.load_colmap_points(path)
    return (
        np.frombuffer(xyz, dtype="<f8").reshape(n, 3).copy(),
        np.frombuffer(rgb, dtype=np.uint8).reshape(n, 3).copy(),
    )


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion -> 3x3 rotation (same formula as the
    projection stage's quat math, ops/projection.py)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3, 3) proper rotation -> COLMAP wxyz unit quaternion (Shepperd's
    branches on the trace and the largest diagonal term), as
    ``scripts/make_synth_colmap.py`` writes it."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w, x, y, z = 0.25 * s, (R[2, 1] - R[1, 2]) / s, \
            (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w, x, y, z = (R[2, 1] - R[1, 2]) / s, 0.25 * s, \
            (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w, x, y, z = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, \
            0.25 * s, (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w, x, y, z = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, \
            (R[1, 2] + R[2, 1]) / s, 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


# One points3D.bin record up to its track: id, xyz, rgb, error, track
# length (numpy's structured dtypes are packed: 51 bytes, COLMAP's layout).
_POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                          ("error", "<f8"), ("track", "<u8")])


def write_cameras_bin(path: str, cameras) -> None:
    """``cameras.bin`` from [(camera_id, model_id, width, height, params)]."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id, model_id, width, height, params in cameras:
            f.write(struct.pack("<iiQQ", cam_id, model_id, width, height))
            f.write(np.asarray(params, "<f8").tobytes())


def write_images_bin(path: str, images) -> None:
    """``images.bin`` from [(image_id, qvec wxyz, tvec, camera_id, name,
    xys (n, 2), point3d_ids (n,))]: each image's 2D observations of the
    given points."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for image_id, qvec, tvec, camera_id, name, xys, pids in images:
            f.write(struct.pack("<i", image_id))
            f.write(np.asarray(qvec, "<f8").tobytes())
            f.write(np.asarray(tvec, "<f8").tobytes())
            f.write(struct.pack("<i", camera_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(pids)))
            rec = np.zeros((len(pids), 3), "<f8")
            rec[:, :2] = xys
            rec[:, 2] = np.asarray(pids, "<i8").view("<f8")
            f.write(rec.tobytes())


def write_points3d_bin(path: str, xyz: np.ndarray, rgb: np.ndarray, *, ids=None,
                       errors=0.5, tracks=None) -> None:
    """``points3D.bin`` from xyz (P, 3) and 8-bit colours rgb (P, 3). ``ids``
    defaults to 0..P-1, ``errors`` (a scalar or (P,)) is the reprojection
    error, and ``tracks`` gives each point its (image_id, point2d_idx)
    pairs; by default every track is empty (the observations live in
    ``images.bin`` alone)."""
    rec = np.zeros(xyz.shape[0], _POINT_RECORD)
    rec["id"] = np.arange(xyz.shape[0]) if ids is None else ids
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    rec["error"] = errors
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        if tracks is None:
            f.write(rec.tobytes())
            return
        rec["track"] = [len(t) for t in tracks]
        for r, t in zip(rec, tracks):
            f.write(r.tobytes())
            f.write(np.asarray(t, "<i4").tobytes())


def camera_intrinsics(cam: ColmapCamera, downscale: int = 1):
    """(fx, fy, cx, cy, W, H, dist, camera_model) from a COLMAP camera,
    downscaled.

    ``dist`` is the coefficient vector Camera.dist expects
    (normalized-coordinate coefficients, so downscaling leaves them
    unchanged) and ``camera_model`` the matching Camera.camera_model.
    Mapped pinhole-family models: SIMPLE_RADIAL (2), RADIAL (3), OPENCV (4),
    FULL_OPENCV (6, truncated to k3) -> OpenCV (k1, k2, p1, p2, k3).
    Mapped fisheye-family models (equidistant, cv::fisheye convention):
    OPENCV_FISHEYE (5), SIMPLE_RADIAL_FISHEYE (8), RADIAL_FISHEYE (9)
    -> (k1, k2, k3, k4, 0). Other models fall back to an ideal pinhole.
    """
    p = cam.params
    if cam.model_id in _SINGLE_FOCAL:
        fx = fy = float(p[0])
        cx, cy = float(p[1]), float(p[2])
    else:
        fx, fy, cx, cy = map(float, p[:4])
    dist = np.zeros(5, np.float32)
    camera_model = "pinhole"
    if cam.model_id == 2:  # SIMPLE_RADIAL: f, cx, cy, k
        dist[0] = p[3]
    elif cam.model_id == 3:  # RADIAL: f, cx, cy, k1, k2
        dist[0], dist[1] = p[3], p[4]
    elif cam.model_id == 4:  # OPENCV: fx, fy, cx, cy, k1, k2, p1, p2
        dist[:4] = p[4:8]
    elif cam.model_id == 6:  # FULL_OPENCV: ... k1, k2, p1, p2, k3 (+k4..k6)
        dist[:4] = p[4:8]
        dist[4] = p[8]
    elif cam.model_id == 5:  # OPENCV_FISHEYE: fx, fy, cx, cy, k1, k2, k3, k4
        dist[:4] = p[4:8]
        camera_model = "fisheye"
    elif cam.model_id == 8:  # SIMPLE_RADIAL_FISHEYE: f, cx, cy, k
        dist[0] = p[3]
        camera_model = "fisheye"
    elif cam.model_id == 9:  # RADIAL_FISHEYE: f, cx, cy, k1, k2
        dist[0], dist[1] = p[3], p[4]
        camera_model = "fisheye"
    s = float(downscale)
    return (fx / s, fy / s, cx / s, cy / s,
            int(cam.width // downscale), int(cam.height // downscale), dist,
            camera_model)


@dataclass
class ColmapScene:
    """A parsed COLMAP capture, ready for training."""

    cameras: dict[int, ColmapCamera]
    images: list[ColmapImage]
    points_xyz: np.ndarray  # (P, 3) float32
    points_rgb: np.ndarray  # (P, 3) float32 in [0, 1]
    points_id: np.ndarray | None = None  # (P,) int64 (with_points2d only)

    def camera_for(self, image: ColmapImage, downscale: int = 1, *,
                   device: torch.device | str):
        """The port's render Camera, on ``device``, for one registered
        image."""
        from ..camera import Camera

        cam = self.cameras[image.camera_id]
        fx, fy, cx, cy, W, H, dist, model = camera_intrinsics(cam, downscale)
        return Camera.create(
            R=qvec_to_rotmat(image.qvec).astype(np.float32),
            T=image.tvec.astype(np.float32),
            H=H, W=W, fx=fx, fy=fy, cx=cx, cy=cy, dist=dist,
            camera_model=model, device=device,
        )


def load_scene(
    sparse_dir: str, with_points2d: bool = False
) -> ColmapScene:
    """Load ``cameras.bin`` / ``images.bin`` / ``points3D.bin`` from a COLMAP
    sparse-model directory (typically ``<capture>/sparse/0``).

    ``with_points2d=True`` additionally retains each image's 2D keypoint
    observations and the point3D id table (Python parsing path), enabling
    :func:`sparse_depth_targets` for depth-supervised training."""
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    if with_points2d:
        images = _read_images_python(
            os.path.join(sparse_dir, "images.bin"), with_points2d=True
        )
        xyz, rgb, pids = _read_points_python(
            os.path.join(sparse_dir, "points3D.bin"), with_ids=True
        )
    else:
        images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        xyz, rgb = read_points3d_bin(
            os.path.join(sparse_dir, "points3D.bin")
        )
        pids = None
    return ColmapScene(
        cameras={c.camera_id: c for c in cams},
        images=sorted(images, key=lambda im: im.name),
        points_xyz=xyz.astype(np.float32),
        points_rgb=rgb.astype(np.float32) / 255.0,
        points_id=pids,
    )


def sparse_depth_targets(
    scene: ColmapScene,
    views: list[ColmapImage],
    downscale: int = 1,
    capacity: int | None = None,
):
    """Per-view sparse depth supervision from the SfM observations.

    For each view, every tracked 2D keypoint becomes one (u, v, depth)
    target: pixel coordinates at the training resolution and the camera-
    frame z of its triangulated 3D point (the supervision signal gsplat's
    depth-loss training mode derives the same way). Points behind the
    camera or outside the image are dropped. Lists are padded to a fixed
    ``capacity`` (default: max count rounded up to 256) so the training
    step stays one compile.

    Requires ``load_scene(with_points2d=True)``. Returns (uv (V, K, 2)
    float32, depth (V, K) float32, mask (V, K) bool).
    """
    if scene.points_id is None:
        raise ValueError("load the scene with with_points2d=True")
    id_to_idx = {int(pid): i for i, pid in enumerate(scene.points_id)}
    per_uv, per_z = [], []
    for im in views:
        if im.xys is None or im.point3d_ids is None or not len(im.xys):
            per_uv.append(np.zeros((0, 2), np.float32))
            per_z.append(np.zeros((0,), np.float32))
            continue
        cam = scene.cameras[im.camera_id]
        W = cam.width // downscale
        H = cam.height // downscale
        tracked = im.point3d_ids >= 0
        idx = np.array(
            [id_to_idx.get(int(p), -1) for p in im.point3d_ids[tracked]],
            np.int64,
        )
        uv = im.xys[tracked][idx >= 0] / float(downscale)
        xyz = scene.points_xyz[idx[idx >= 0]]
        z = (xyz @ qvec_to_rotmat(im.qvec).T + im.tvec)[:, 2]
        keep = (
            (z > 1e-3)
            & (uv[:, 0] >= 0) & (uv[:, 0] < W)
            & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        )
        per_uv.append(uv[keep].astype(np.float32))
        per_z.append(z[keep].astype(np.float32))
    K = capacity or max(1, -(-max(len(z) for z in per_z) // 256) * 256)
    V = len(views)
    uv = np.zeros((V, K, 2), np.float32)
    depth = np.ones((V, K), np.float32)
    mask = np.zeros((V, K), bool)
    for i, (u, z) in enumerate(zip(per_uv, per_z)):
        k = min(len(z), K)
        uv[i, :k] = u[:k]
        depth[i, :k] = z[:k]
        mask[i, :k] = True
    return uv, depth, mask


def init_gaussians_from_points(
    xyz: np.ndarray,
    rgb: np.ndarray,
    sh_degree: int | None = 3,
    init_opacity: float = 0.1,
) -> dict:
    """Standard 3DGS initialization from an SfM point cloud.

    Means at the points; SH DC from colors (C0 = 0.28209479); isotropic
    log-scales at the log of each point's mean distance to its 3 nearest
    neighbors (the INRIA heuristic); opacity logits at
    ``logit(init_opacity)``. Returns the raw (trainable) parameter dict of
    ``train.init_gaussians`` as numpy arrays.
    """
    n = xyz.shape[0]
    d3 = _mean_knn_dist(xyz.astype(np.float32), k=3)
    log_scales = np.log(np.clip(d3, 1e-7, None))[:, None].repeat(3, axis=1)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    opac = np.full((n,), float(np.log(init_opacity / (1 - init_opacity))),
                   np.float32)
    dc = (rgb.astype(np.float32) - 0.5) / 0.28209479177387814
    if sh_degree is None:
        features = rgb.astype(np.float32)
    else:
        K = num_sh_bases(sh_degree)
        features = np.zeros((n, K, 3), np.float32)
        features[:, 0, :] = dc
    return dict(
        means3d=xyz.astype(np.float32),
        scales=log_scales.astype(np.float32),
        quats=quats,
        opacities_raw=opac,
        features=features,
    )


def _mean_knn_dist(xyz: np.ndarray, k: int = 3,
                   block: int = 4096, max_exact: int = 131072,
                   window: int = 48) -> np.ndarray:
    """Mean distance to the k nearest neighbors, blocked numpy.

    Exact O(N^2) up to ``max_exact`` points. Beyond that (SfM-dense
    clouds; a quadratic pass at 1M points costs hours on one CPU),
    candidates come from a Morton-order window: points
    sorted by the Z-curve are 3D-local, so each point's true nearest
    neighbors are almost always within +-``window`` positions in the
    sorted order — O(N * window) with exact distances to the candidates.
    A global random-subsample estimate is NOT acceptable here: at 1M
    points a 4k reference overestimates NN distances ~(N/ref)^(1/3) ~ 6x,
    which seeds splats ~40x too large in area and wrecks training
    (observed: blurry low-frequency fits under blown-out intersection
    budgets)."""
    n = xyz.shape[0]
    if n <= k:
        return np.ones((n,), np.float32)
    if n > max_exact:
        from .compress import morton_order

        order = morton_order(xyz.astype(np.float32))
        inv = np.empty_like(order)
        inv[order] = np.arange(n)
        s = xyz[order].astype(np.float32)
        d2 = np.full((n, 2 * window), np.inf, np.float32)
        for j in range(1, window + 1):
            diff = s[j:] - s[:-j]
            dd = (diff * diff).sum(-1)
            d2[j:, window + j - 1] = dd  # neighbor j positions back
            d2[:-j, window - j] = dd  # neighbor j positions ahead
        part = np.partition(d2, k - 1, axis=1)[:, :k]
        out_sorted = np.sqrt(np.clip(part, 0, None)).mean(axis=1)
        return out_sorted[inv].astype(np.float32)
    out = np.empty((n,), np.float32)
    sq = (xyz**2).sum(-1)
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        d2 = sq[i0:i1, None] - 2.0 * xyz[i0:i1] @ xyz.T + sq[None, :]
        np.fill_diagonal(d2[:, i0:i1], np.inf)
        part = np.partition(d2, k, axis=1)[:, :k]
        out[i0:i1] = np.sqrt(np.clip(part, 0, None)).mean(axis=1)
    return out
