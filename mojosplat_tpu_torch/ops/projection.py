"""EWA projection of 3D gaussians to 2D screen-space conics (PyTorch).

Counterpart of ``mojosplat_tpu.ops.projection`` for the pinhole EWA path:
the element-wise ``_fused_cov2d`` (quat -> Sigma -> camera frame -> 2D
covariance with no (N, 3, 3) intermediates), the eps2d dilation, the
antialiasing compensation, the opacity-aware radius and the cull masks.
Culled gaussians get radius 0; shapes never depend on the data.

The unscented projection (``projection_mode="ut"``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import Camera
from ..config import DEFAULT_CONFIG, RenderConfig


class ProjectionResult(NamedTuple):
    """means2d (N, 2) pixel centres; conics (N, 3) inverse 2D covariance
    upper triangle [a, b, c]; depths (N,) camera z; radii (N, 2) int32
    (0 => culled); compensations (N,) antialiasing opacity factor."""

    means2d: torch.Tensor
    conics: torch.Tensor
    depths: torch.Tensor
    radii: torch.Tensor
    compensations: torch.Tensor


def s2c(saa, sab, sbb, a):
    """Quadratic form (1, -a) [[saa, sab], [sab, sbb]] (1, -a)^T."""
    return saa - 2.0 * a * sab + a * a * sbb


def _fused_cov2d(means3d, scales, quats, camera: Camera):
    """Element-wise EWA projection. Returns (means2d (N, 2), depths (N,),
    c00, c01, c11) with the 2D covariance not yet eps2d-dilated."""
    norm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    q = quats / torch.clamp(norm, min=1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    s0, s1, s2 = (torch.exp(scales[:, i]) for i in range(3))

    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)

    # Sigma = (R S)(R S)^T, unique entries only.
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    s_00 = m00 * m00 + m01 * m01 + m02 * m02
    s_01 = m00 * m10 + m01 * m11 + m02 * m12
    s_02 = m00 * m20 + m01 * m21 + m02 * m22
    s_11 = m10 * m10 + m11 * m11 + m12 * m12
    s_12 = m10 * m20 + m11 * m21 + m12 * m22
    s_22 = m20 * m20 + m21 * m21 + m22 * m22

    V = camera.view_matrix
    v = [[V[i, j] for j in range(3)] for i in range(3)]
    tvec = [V[i, 3] for i in range(3)]

    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    tx, ty, tz = (
        v[i][0] * mx + v[i][1] * my + v[i][2] * mz + tvec[i] for i in range(3)
    )

    # Sigma_c = V Sigma V^T via t_i = Sigma @ v_i (Sigma symmetric).
    def sig_v(a):
        return (
            s_00 * a[0] + s_01 * a[1] + s_02 * a[2],
            s_01 * a[0] + s_11 * a[1] + s_12 * a[2],
            s_02 * a[0] + s_12 * a[1] + s_22 * a[2],
        )

    def dot_v(t, a):
        return t[0] * a[0] + t[1] * a[1] + t[2] * a[2]

    t0, t1, t2 = sig_v(v[0]), sig_v(v[1]), sig_v(v[2])
    sc00 = dot_v(t0, v[0])
    sc01 = dot_v(t0, v[1])
    sc02 = dot_v(t0, v[2])
    sc11 = dot_v(t1, v[1])
    sc12 = dot_v(t1, v[2])
    sc22 = dot_v(t2, v[2])

    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    width, height = camera.W, camera.H

    # Lanes at or behind the camera plane are culled downstream by the
    # near-plane mask (which reads the real tz), but their 1/z^2 factors
    # would overflow f32 to inf; a dummy z = 1 keeps every value finite.
    z_floor = torch.clamp(camera.near, max=1e-3).to(tz.dtype)
    tz_safe = torch.where(tz > z_floor, tz, torch.ones_like(tz))
    rz = 1.0 / tz_safe
    rz2 = rz * rz

    # Frustum guard-band clamp.
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    txc = tz_safe * torch.clamp(tx * rz, -lim_x_neg, lim_x_pos)
    tyc = tz_safe * torch.clamp(ty * rz, -lim_y_neg, lim_y_pos)

    ax = txc * rz
    ay = tyc * rz
    c00 = fx * fx * rz2 * (s2c(sc00, sc02, sc22, ax))
    c11 = fy * fy * rz2 * (s2c(sc11, sc12, sc22, ay))
    c01 = fx * fy * rz2 * (sc01 - ay * sc02 - ax * sc12 + ax * ay * sc22)

    means2d = torch.stack([fx * tx * rz + cx, fy * ty * rz + cy], dim=-1)
    return means2d, tz, c00, c01, c11


def project_gaussians(
    means3d: torch.Tensor,  # (N, 3) world-space centres
    scales: torch.Tensor,  # (N, 3) log-space scales
    quats: torch.Tensor,  # (N, 4) wxyz quaternions
    opacities: torch.Tensor,  # (N,) post-activation opacities
    camera: Camera,
    config: RenderConfig = DEFAULT_CONFIG,
) -> ProjectionResult:
    """Project 3D gaussians to screen space with culling (EWA, pinhole)."""
    if config.projection_mode == "ut":
        raise NotImplementedError("projection_mode='ut' is not ported yet")
    if config.projection_mode != "ewa":
        raise ValueError(f"Unknown projection_mode: {config.projection_mode!r}")
    if camera.camera_model != "pinhole" or camera.shutter != "global":
        raise NotImplementedError("only the pinhole global-shutter camera is ported")

    means2d, depths, c00_raw, c01_raw, c11_raw = _fused_cov2d(
        means3d, scales, quats, camera
    )

    # eps2d dilation and determinant clamp.
    c00 = c00_raw + config.eps2d
    c11 = c11_raw + config.eps2d
    c01 = c01_raw
    det = torch.clamp(c00 * c11 - c01 * c01, min=1e-10)
    conics = torch.stack([c11 / det, -c01 / det, c00 / det], dim=-1)

    if config.antialiased:
        det_raw = c00_raw * c11_raw - c01_raw * c01_raw
        pos = det_raw > 0.0
        det_raw_safe = torch.where(pos, det_raw, torch.ones_like(det_raw))
        compensations = torch.where(
            pos, torch.sqrt(det_raw_safe / det), torch.zeros_like(det)
        )
    else:
        compensations = torch.ones_like(det)

    if config.opacity_aware_radius:
        safe_op = torch.clamp(opacities, min=config.alpha_threshold)
        extend = torch.clamp(
            torch.sqrt(2.0 * torch.log(safe_op / config.alpha_threshold)),
            max=config.radius_extend,
        )
    else:
        extend = config.radius_extend
    radius_x = torch.ceil(extend * torch.sqrt(torch.clamp(c00, min=0.0)))
    radius_y = torch.ceil(extend * torch.sqrt(torch.clamp(c11, min=0.0)))

    valid = (det > 0) & (depths > camera.near) & (depths < camera.far)
    if config.opacity_aware_radius:
        valid &= opacities >= config.alpha_threshold
    valid &= ~((radius_x <= config.radius_clip) & (radius_y <= config.radius_clip))
    inside = (
        (means2d[:, 0] + radius_x > 0)
        & (means2d[:, 0] - radius_x < camera.W)
        & (means2d[:, 1] + radius_y > 0)
        & (means2d[:, 1] - radius_y < camera.H)
    )
    keep = valid & inside

    radius = torch.stack([radius_x, radius_y], dim=-1)
    radius = torch.where(keep[:, None], radius, torch.zeros_like(radius))
    radii = radius.detach().to(torch.int32)

    return ProjectionResult(
        means2d=means2d,
        conics=conics,
        depths=depths,
        radii=radii,
        compensations=compensations,
    )
