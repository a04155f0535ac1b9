"""Projection of 3D gaussians to 2D screen-space conics (PyTorch).

Counterpart of ``mojosplat_tpu.ops.projection``, plain PyTorch with
autograd:

  - EWA (``projection_mode="ewa"``): the element-wise ``_fused_cov2d``
    (quat -> Sigma -> camera frame -> 2D covariance with no (N, 3, 3)
    intermediates), pinhole with the guard-band clamp, or orthographic,
    where the map is affine and EWA exact;
  - the unscented transform (``"ut"``, ``_unscented_cov2d``): the 7 sigma
    points of each gaussian go through the exact camera map, the lens
    (``apply_lens``: OpenCV radial/tangential, or equidistant fisheye) and,
    for a rolling shutter, each point's own row-time pose by fixed-point
    iteration. Fisheye and rolling-shutter cameras always take this route.

Both feed the eps2d dilation, the antialiasing compensation, the
opacity-aware radius and the cull masks. Culled gaussians get radius 0;
shapes never depend on the data. The public helpers ``quat_to_rotmat``,
``quat_scale_to_covar``, ``world_to_cam`` and ``persp_proj`` are the
reference's (N, 3, 3) forms of the same math.

Where a branch's backward would be 0/0 or overflow (the lens on the
optical axis, sigma points behind the camera, the rolling shutter's zero
rotation), the branch's input is sanitised, not only its output (double
where). Where the reference clips or takes a max through which a gradient
flows, ``torch.maximum`` / ``torch.minimum`` keep its rule of splitting a
tie's gradient in half (``torch.clamp`` would pass all of it).
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


def clip(x, lo, hi):
    """``jnp.clip``: a max then a min, each splitting a tie's gradient in
    half (``torch.clamp`` passes all of it)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions, normalised first -> (..., 3, 3) rotation
    matrices."""
    norm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    q = quats / torch.clamp(norm, min=1e-12)
    w, x, y, z = torch.movedim(q, -1, 0)
    R = torch.stack(
        [
            1 - 2 * (y**2 + z**2),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x**2 + z**2),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x**2 + y**2),
        ],
        dim=-1,
    )
    return R.reshape(quats.shape[:-1] + (3, 3))


def quat_scale_to_covar(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """3D covariance Sigma = (R S)(R S)^T from wxyz quats and *linear*
    scales."""
    M = quat_to_rotmat(quats) * scales[..., None, :]  # R @ diag(s)
    return torch.einsum("...ij,...kj->...ik", M, M)


def world_to_cam(means: torch.Tensor, covars: torch.Tensor,
                 viewmat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Means (N, 3) and covariances (N, 3, 3) into the camera frame of the
    (4, 4) world-to-camera ``viewmat``."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    means_c = torch.einsum("ij,nj->ni", R, means) + t
    covars_c = torch.einsum("ij,njk,lk->nil", R, covars, R)
    return means_c, covars_c


def persp_proj(means_c, covars_c, fx, fy, cx, cy, width: int, height: int, near=0.1):
    """Perspective EWA projection of camera-frame means (N, 3) and
    covariances (N, 3, 3) with the 0.3 tan(fov) guard band: (means2d (N,
    2), cov2d (N, 2, 2)). Gaussians at or behind the camera get a dummy
    z = 1 (the near-plane cull removes them) so nothing overflows."""
    tx, ty, tz = means_c[:, 0], means_c[:, 1], means_c[:, 2]
    z_floor = torch.clamp(torch.as_tensor(near, dtype=tz.dtype, device=tz.device), max=1e-3)
    tz_safe = torch.where(tz > z_floor, tz, torch.ones_like(tz))
    tz2 = tz_safe * tz_safe

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    tx_c = tz_safe * clip(tx / tz_safe, -lim_x_neg, lim_x_pos)
    ty_c = tz_safe * clip(ty / tz_safe, -lim_y_neg, lim_y_pos)

    O = torch.zeros_like(tz)
    J = torch.stack(
        [fx / tz_safe, O, -fx * tx_c / tz2, O, fy / tz_safe, -fy * ty_c / tz2], dim=-1
    ).reshape(-1, 2, 3)
    cov2d = torch.einsum("nij,njk,nlk->nil", J, covars_c, J)
    means2d = torch.stack([fx * tx / tz_safe + cx, fy * ty / tz_safe + cy], dim=-1)
    return means2d, cov2d


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

    if camera.camera_model == "ortho":
        # The orthographic map is affine, so EWA is exact:
        # J = [[fx, 0, 0], [0, fy, 0]].
        c00 = fx * fx * sc00
        c01 = fx * fy * sc01
        c11 = fy * fy * sc11
        means2d = torch.stack([fx * tx + cx, fy * ty + cy], dim=-1)
        return means2d, tz, c00, c01, c11

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


def apply_lens(camera: Camera, xn, yn):
    """The lens map: undistorted normalised coordinates -> distorted ones.

    ``"pinhole"``: OpenCV radial/tangential distortion (k1, k2, p1, p2,
    k3); zero coefficients give the ideal pinhole bit for bit.
    ``"fisheye"``: OpenCV equidistant, r = |(xn, yn)|, theta = atan(r),
    theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8), out =
    (theta_d / r) (xn, yn).
    """
    if camera.camera_model == "fisheye":
        k1, k2, k3, k4 = (camera.dist[..., i] for i in range(4))
        r2 = xn * xn + yn * yn
        # theta_d / r is 0/0 on the optical axis: sanitise the input so the
        # unselected branch's backward stays finite (the map is even in r,
        # so the true derivative of the scale there is 0).
        on_axis = r2 < 1e-12
        r = torch.sqrt(torch.where(on_axis, torch.ones_like(r2), r2))
        th = torch.arctan(r)
        th2 = th * th
        th_d = th * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
        scale = torch.where(on_axis, torch.ones_like(r), th_d / r)
        return xn * scale, yn * scale
    k1, k2, p1, p2, k3 = (camera.dist[..., i] for i in range(5))
    r2 = xn * xn + yn * yn
    factor = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * factor + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * factor + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def _rs_rotate(v, t, om):
    """exp([t omega]x) v for sigma points v (N, 7, 3) at row times t (N,
    7): Rodrigues in vector form with theta^2 Taylor switches, so it is
    smooth at omega = 0 and t = 0 (double where: the unselected branch's
    input is sanitised too)."""
    w = t[..., None] * om  # (N, 7, 3)
    th2 = torch.sum(w * w, dim=-1)
    small = th2 < 1e-12
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe)
    c = torch.cos(torch.where(small, torch.zeros_like(th), th))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - c) / th2_safe)
    cross = torch.linalg.cross(w, v, dim=-1)
    dot = torch.sum(w * v, dim=-1, keepdim=True)
    cos_full = torch.where(small, 1.0 - th2 / 2.0, c)
    return v * cos_full[..., None] + cross * a[..., None] + w * (dot * b[..., None])


def _unscented_cov2d(means3d, scales, quats, camera: Camera, config: RenderConfig):
    """The unscented projection (3DGUT): the 2d + 1 = 7 sigma points of each
    gaussian (the centre plus and minus the scaled columns of M = R_view R
    S, an exact square root of the camera-frame covariance) go through the
    exact camera map and lens; the 2D mean and covariance are their
    weighted moments (standard UT weights: lambda = alpha^2 (d + kappa) -
    d, w0_m = lambda / (d + lambda), w0_c = w0_m + 1 - alpha^2 + beta, wi =
    1 / (2 (d + lambda))).

    A rolling shutter solves each sigma point's row time t by
    ``config.rs_iterations`` fixed-point steps through the exact map (t =
    clip(v / H, 0, 1) - 0.5), the depth being the centre's at its own row
    time. Returns (means2d, depths, c00, c01, c11) as ``_fused_cov2d``,
    the covariance not yet eps2d-dilated."""
    d = 3.0
    lam = config.ut_alpha**2 * (d + config.ut_kappa) - d
    dt, dev = means3d.dtype, means3d.device
    gamma = torch.sqrt(torch.tensor(d + lam, dtype=dt, device=dev))

    R = quat_to_rotmat(quats)  # (N, 3, 3)
    M = R * torch.exp(scales)[:, None, :]  # R @ diag(s)
    mu_c = means3d @ camera.R.T + camera.T  # (N, 3) camera frame
    Mc = torch.einsum("ij,njk->nik", camera.R, M)
    cols = gamma * Mc.transpose(1, 2)  # rows = the scaled columns

    # Behind-camera gaussians are culled downstream (by their real depth),
    # but their sigma points would carry huge values into the backward:
    # their inputs become a unit dummy. A straddling splat's points get a
    # z floor of 1% of its centre's depth, bounding them to ~100x the focal
    # scale (the UT counterpart of EWA's guard band).
    zc = mu_c[:, 2]
    ok = zc > 1e-3
    mu_safe = torch.where(ok[:, None], mu_c, torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev))
    cols_safe = torch.where(ok[:, None, None], cols, torch.zeros_like(cols))
    pts = torch.cat([mu_safe[:, None, :], mu_safe[:, None, :] + cols_safe,
                     mu_safe[:, None, :] - cols_safe], dim=1)  # (N, 7, 3)
    z_floor = 0.01 * torch.where(ok, zc, torch.ones_like(zc))

    def to_pixels(p):
        """(N, 7, 3) camera-frame points -> (N, 7, 2) pixels."""
        if camera.camera_model == "ortho":
            xd, yd = p[..., 0], p[..., 1]  # no z divide, no lens
        else:
            z = torch.maximum(p[..., 2], z_floor[:, None])
            xd, yd = apply_lens(camera, p[..., 0] / z, p[..., 1] / z)
        return torch.stack([camera.fx * xd + camera.cx, camera.fy * yd + camera.cy], dim=-1)

    if camera.shutter == "rolling":
        om, up = camera.rs_vel[..., 0:3], camera.rs_vel[..., 3:6]
        t = torch.zeros(pts.shape[:-1], dtype=dt, device=dev)  # (N, 7) row times
        for _ in range(config.rs_iterations):
            p_t = _rs_rotate(pts, t, om) + t[..., None] * up
            t = clip(to_pixels(p_t)[..., 1] / camera.H, 0.0, 1.0) - 0.5
        p_t = _rs_rotate(pts, t, om) + t[..., None] * up
        y = to_pixels(p_t)
        zc = torch.where(ok, p_t[:, 0, 2], zc)
    else:
        y = to_pixels(pts)  # (N, 7, 2)

    w0_m = lam / (d + lam)
    wi = 1.0 / (2.0 * (d + lam))
    w0_c = w0_m + 1.0 - config.ut_alpha**2 + config.ut_beta
    wm = torch.tensor([w0_m] + [wi] * 6, dtype=dt, device=dev)
    wc = torch.tensor([w0_c] + [wi] * 6, dtype=dt, device=dev)
    mean = torch.einsum("k,nkc->nc", wm, y)
    diff = y - mean[:, None, :]
    c00 = torch.einsum("k,nk->n", wc, diff[..., 0] * diff[..., 0])
    c01 = torch.einsum("k,nk->n", wc, diff[..., 0] * diff[..., 1])
    c11 = torch.einsum("k,nk->n", wc, diff[..., 1] * diff[..., 1])
    return mean, zc, c00, c01, c11


def project_gaussians(
    means3d: torch.Tensor,  # (N, 3) world-space centres
    scales: torch.Tensor,  # (N, 3) log-space scales
    quats: torch.Tensor,  # (N, 4) wxyz quaternions
    opacities: torch.Tensor,  # (N,) post-activation opacities
    camera: Camera,
    config: RenderConfig = DEFAULT_CONFIG,
) -> ProjectionResult:
    """Project 3D gaussians to screen space with culling. Fisheye and
    rolling-shutter cameras take the unscented route whatever
    ``config.projection_mode`` says: EWA's linearisation is the
    perspective map's, and a rolling shutter's per-point row time has no
    EWA Jacobian."""
    if (config.projection_mode == "ut" or camera.camera_model == "fisheye"
            or camera.shutter == "rolling"):
        means2d, depths, c00_raw, c01_raw, c11_raw = _unscented_cov2d(
            means3d, scales, quats, camera, config
        )
    elif config.projection_mode == "ewa":
        means2d, depths, c00_raw, c01_raw, c11_raw = _fused_cov2d(
            means3d, scales, quats, camera
        )
    else:
        raise ValueError(f"Unknown projection_mode: {config.projection_mode!r}")

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
