"""Mesh extraction from trained surfel (2DGS) scenes: TSDF fusion of
rendered depth maps + marching tetrahedra.

Port of ``mojosplat_tpu.utils.mesh`` (the 2DGS paper's reconstruction,
Huang et al. 2024, sec. 5):

  - ``tsdf_fuse``: projective truncated-signed-distance fusion on a voxel
    grid, in PyTorch on the cameras' device (one pass per view, bilinear
    depth sampling and alpha masking), with the reference's order of
    operations.
  - ``marching_tetrahedra``: isosurface extraction on the host in numpy, a
    copy of the reference's (same vertices and faces, same order). Each
    cube splits into 6 tetrahedra around its main diagonal; a tetrahedron
    gives 0-2 triangles, vertices linearly interpolated along its
    sign-crossing edges, oriented so normals point toward positive SDF.
  - ``save_mesh_ply`` / ``save_mesh_obj``: dependency-free writers.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

# The classic 6-tetrahedra cube decomposition around the 0-7 main diagonal.
# Cube corner i sits at offset (i & 1, (i >> 1) & 1, (i >> 2) & 1).
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int32,
)
_CORNER_OFFSETS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
    np.int32,
)  # (8, 3) in (x, y, z) order


@contextmanager
def _full_f32_matmul():
    """Matmuls in full f32 inside the block (no TF32 on the card)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _fuse_one(pts, acc_t, acc_w, depth, alpha, cam, trunc: float, alpha_floor: float):
    """One view's pass: the voxels ``pts`` (V, 3) into the camera, their
    bilinear depth and alpha samples, and the truncated SDF added to the
    running sums where the view observes the voxel."""
    pc = pts @ cam.R.T + cam.T  # (V, 3) camera frame
    z = pc[:, 2]
    z_safe = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = cam.fx * pc[:, 0] / z_safe + cam.cx - 0.5  # continuous pixel coords
    v = cam.fy * pc[:, 1] / z_safe + cam.cy - 0.5
    H, W = depth.shape
    # Clamped before the cast, so a far-off voxel cannot overflow int32.
    u0 = torch.clamp(torch.floor(u), 0, W - 2).to(torch.int64)
    v0 = torch.clamp(torch.floor(v), 0, H - 2).to(torch.int64)
    du = torch.clamp(u - u0, 0.0, 1.0)
    dv = torch.clamp(v - v0, 0.0, 1.0)

    def samp(img):
        a = img[v0, u0]
        b = img[v0, u0 + 1]
        c = img[v0 + 1, u0]
        d = img[v0 + 1, u0 + 1]
        return (a * (1 - du) * (1 - dv) + b * du * (1 - dv)
                + c * (1 - du) * dv + d * du * dv)

    d_s = samp(depth)
    a_s = samp(alpha)
    sdf = d_s - z  # + in front of surface, - behind
    valid = (
        (z > 1e-6)
        & (u >= 0.0) & (u <= W - 1.0)
        & (v >= 0.0) & (v <= H - 1.0)
        & (a_s > alpha_floor)
        & (sdf > -trunc)  # never carve far behind an observed surface
    )
    t = torch.clamp(sdf / trunc, -1.0, 1.0)
    w = valid.to(torch.float32)
    return acc_t + w * t, acc_w + w


def tsdf_fuse(
    depths,  # list of (H, W) EXPECTED depth maps (already alpha-divided)
    alphas,  # list of (H, W) coverage maps in [0, 1]
    cameras,  # list of Camera (pinhole)
    bounds,  # ((3,), (3,)) world-space (lo, hi) of the voxel grid
    resolution: int = 192,
    trunc: float | None = None,
    alpha_floor: float = 0.5,
):
    """Fuse per-view depth maps into a TSDF grid, on the first camera's
    device (the maps may be tensors or numpy arrays).

    Returns numpy (tsdf (R, R, R), weight (R, R, R), origin (3,), spacing
    (3,)), with tsdf in [-1, 1] (positive OUTSIDE, i.e. in front of the
    surface toward the cameras) and weight 0 where no view observed the
    voxel. Grid axes are indexed [x, y, z] in world coordinates.
    """
    lo = np.asarray(bounds[0], np.float32)
    hi = np.asarray(bounds[1], np.float32)
    spacing = (hi - lo) / (resolution - 1)
    if trunc is None:
        trunc = 4.0 * float(spacing.max())

    axes = [
        lo[i] + spacing[i] * np.arange(resolution, dtype=np.float32)
        for i in range(3)
    ]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts_np = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    device = cameras[0].R.device
    pts = torch.from_numpy(pts_np).to(device)
    acc_t = torch.zeros((pts.shape[0],), dtype=torch.float32, device=device)
    acc_w = torch.zeros((pts.shape[0],), dtype=torch.float32, device=device)
    with torch.no_grad(), _full_f32_matmul():
        for depth, alpha, cam in zip(depths, alphas, cameras):
            acc_t, acc_w = _fuse_one(
                pts, acc_t, acc_w,
                torch.as_tensor(depth, dtype=torch.float32, device=device),
                torch.as_tensor(alpha, dtype=torch.float32, device=device),
                cam, trunc, alpha_floor,
            )

    w = acc_w.cpu().numpy().reshape(resolution, resolution, resolution)
    t = acc_t.cpu().numpy().reshape(resolution, resolution, resolution)
    tsdf = np.where(w > 0, t / np.maximum(w, 1e-12), 1.0).astype(np.float32)
    return tsdf, w, lo, spacing.astype(np.float32)


def marching_tetrahedra(
    sdf: np.ndarray,  # (X, Y, Z) signed field (positive outside)
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    level: float = 0.0,
    mask: np.ndarray | None = None,
):
    """Extract the ``level`` isosurface. Returns (verts (V, 3) f32,
    faces (F, 3) i32) with outward (toward positive sdf) orientation.

    ``mask``: optional (X, Y, Z) bool of trusted samples; cubes touching an
    untrusted corner are skipped (used to suppress surfaces at the
    unobserved-space boundary of a TSDF).
    """
    s = np.asarray(sdf, np.float32) - level
    X, Y, Z = s.shape
    # Corner sample grids per cube: (X-1, Y-1, Z-1, 8) values and validity.
    cs = np.stack(
        [
            s[o[0] : o[0] + X - 1, o[1] : o[1] + Y - 1, o[2] : o[2] + Z - 1]
            for o in _CORNER_OFFSETS
        ],
        axis=-1,
    ).reshape(-1, 8)
    if mask is not None:
        m = np.asarray(mask, bool)
        cm = np.stack(
            [
                m[o[0] : o[0] + X - 1, o[1] : o[1] + Y - 1,
                  o[2] : o[2] + Z - 1]
                for o in _CORNER_OFFSETS
            ],
            axis=-1,
        ).reshape(-1, 8).all(axis=-1)
    else:
        cm = np.ones(cs.shape[0], bool)

    # Active cubes: a sign change among trusted corners.
    inside = cs < 0.0
    active = cm & inside.any(axis=-1) & (~inside.all(axis=-1))
    idx = np.nonzero(active)[0]
    if idx.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    nx, ny = X - 1, Y - 1
    # Cube base coordinates (x, y, z) from the flattened (X-1, Y-1, Z-1).
    bz = idx % (Z - 1)
    by = (idx // (Z - 1)) % ny
    bx = idx // ((Z - 1) * ny)
    base = np.stack([bx, by, bz], axis=-1).astype(np.float32)  # (A, 3)
    vals = cs[idx]  # (A, 8)
    corner_pos = base[:, None, :] + _CORNER_OFFSETS[None, :, :]  # (A, 8, 3)

    spacing = np.asarray(spacing, np.float32)
    origin = np.asarray(origin, np.float32)

    tris = []

    def edge_point(pi, pj, si, sj):
        # Linear zero crossing along the edge; si, sj have opposite signs.
        t = si / (si - sj)
        return pi + t[:, None] * (pj - pi)

    for tet in _TETS:
        tv = vals[:, tet]  # (A, 4)
        tp = corner_pos[:, tet, :]  # (A, 4, 3)
        neg = tv < 0.0
        nneg = neg.sum(axis=-1)

        # Case: exactly one vertex on one side -> one triangle.
        for lone_inside in (True, False):
            tgt = 1 if lone_inside else 3
            sel = np.nonzero(nneg == tgt)[0]
            if sel.size == 0:
                continue
            neg_s = neg[sel]
            lone = (
                np.argmax(neg_s, axis=-1)
                if lone_inside
                else np.argmax(~neg_s, axis=-1)
            )
            others = np.argsort(
                (np.arange(4)[None, :] == lone[:, None]), axis=-1,
                kind="stable",
            )[:, :3]  # the three non-lone vertex slots, in index order
            ar = np.arange(sel.size)
            pl_ = tp[sel][ar, lone]
            sl = tv[sel][ar, lone]
            pts3 = [
                edge_point(pl_, tp[sel][ar, others[:, j]],
                           sl, tv[sel][ar, others[:, j]])
                for j in range(3)
            ]
            tris.append(np.stack(pts3, axis=1))

        # Case: two vs two -> a quad = two triangles.
        pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        for a, b in pairs:
            pat = np.zeros(4, bool)
            pat[[a, b]] = True
            sel = np.nonzero((neg == pat[None, :]).all(axis=-1))[0]
            if sel.size == 0:
                continue
            c, d = [k for k in range(4) if k not in (a, b)]
            tvs, tps = tv[sel], tp[sel]
            # Quad corners: crossings on edges a-c, a-d, b-d, b-c (a ring).
            q1 = edge_point(tps[:, a], tps[:, c], tvs[:, a], tvs[:, c])
            q2 = edge_point(tps[:, a], tps[:, d], tvs[:, a], tvs[:, d])
            q3 = edge_point(tps[:, b], tps[:, d], tvs[:, b], tvs[:, d])
            q4 = edge_point(tps[:, b], tps[:, c], tvs[:, b], tvs[:, c])
            tris.append(np.stack([q1, q2, q3], axis=1))
            tris.append(np.stack([q1, q3, q4], axis=1))

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tri = np.concatenate(tris, axis=0)  # (T, 3, 3) in grid coordinates

    # Orient numerically: the normal must point toward positive sdf. The
    # local field gradient at the triangle centroid is estimated by central
    # differences on the grid.
    cen = tri.mean(axis=1)
    ci = np.clip(np.round(cen).astype(np.int32), 1,
                 np.array([X, Y, Z]) - 2)
    grad = np.stack(
        [
            s[ci[:, 0] + 1, ci[:, 1], ci[:, 2]]
            - s[ci[:, 0] - 1, ci[:, 1], ci[:, 2]],
            s[ci[:, 0], ci[:, 1] + 1, ci[:, 2]]
            - s[ci[:, 0], ci[:, 1] - 1, ci[:, 2]],
            s[ci[:, 0], ci[:, 1], ci[:, 2] + 1]
            - s[ci[:, 0], ci[:, 1], ci[:, 2] - 1],
        ],
        axis=-1,
    )
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("td,td->t", n, grad) < 0.0
    tri[flip] = tri[flip][:, [0, 2, 1]]

    # Deduplicate vertices (quantized to 1e-4 of a voxel).
    flat = tri.reshape(-1, 3)
    keys = np.round(flat * 1e4).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float32)
    verts[inv] = flat  # last write wins; all writers agree to 1e-4 voxel
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces created by vertices snapping together.
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]

    verts = origin[None, :] + verts * spacing[None, :]
    return verts, faces


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY mesh writer (dependency-free)."""
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    ).encode()
    v = np.asarray(verts, "<f4")
    f = np.asarray(faces, "<i4")
    counts = np.full((len(f), 1), 3, np.uint8)
    face_rec = np.zeros(len(f), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    face_rec["n"] = counts[:, 0]
    face_rec["idx"] = f
    with open(path, "wb") as fo:
        fo.write(header)
        fo.write(v.tobytes())
        fo.write(face_rec.tobytes())


def save_mesh_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fo:
        for v in verts:
            fo.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fo.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
