"""2D Gaussian Splatting (surfels): the second primitive family (PyTorch).

Counterpart of ``mojosplat_tpu.surfel``. Each primitive is a flat
elliptical disk: centre ``p``, tangent axes ``t_u, t_v`` (the first two
columns of the quaternion's rotation) and scales ``(s_u, s_v)``. A pixel's
response comes from the exact ray/disk intersection. In the camera frame,
with ``qc = R p + T``, ``a = s_u R t_u`` and ``b = s_v R t_v``, the point
hit by the ray of normalised coordinates ``(xn, yn)`` solves

    u (a_x - xn a_z) + v (b_x - xn b_z) = xn qc_z - qc_x
    u (a_y - yn a_z) + v (b_y - yn b_z) = yn qc_z - qc_y

and the response is ``max(exp(-(u^2 + v^2) / 2), g_filter)``, where
``g_filter`` is the paper's screen-space low-pass gaussian of variance 0.5
px^2 around the projected centre.

Culling, radii and binning are the 3DGS ones on the flattened gaussian
(log-scales ``(s_u, s_v, -13.8)``), with the radii widened to the filter's
support. Two routes blend:

  - ``"torch"``: ``rasterize_torch_generic`` with the alpha model
    ``_surfel_alphas`` in normalised coordinates (the reference's ``"xla"``);
  - ``"cuda"``: the slot table (B5), one packed gather of intrinsics-primed
    columns, and the surfel blend kernels B6 (image) / B7 (image, normals
    and intersection-depth moments) with their backward B8
    (``ops/surfel_cuda.py``; the reference's ``"pallas"``).

The two compute the alpha in different coordinates and agree to f32
rounding.

Camera models: pinhole rays ``t (xn, yn, 1)``; fisheye rays the same
with ``(xn, yn)`` from inverting the equidistant lens at each pixel
(``_invert_equidistant``); ortho rays parallel, from ``(xn, yn, 0)`` along
``(0, 0, 1)``, so the 2x2 system loses its z terms. The kernels take the
pinhole, and ortho without the maps (primed so its z rows read ``(1, 0,
0)``, ``primed_surfel_columns``); as in the reference, the ``"cuda"``
route raises ``NotImplementedError`` for fisheye and for ortho with the
maps, which the ``"torch"`` route renders.

``viewport_rows=(row0, h)`` renders the slab of image rows ``[row0, row0 +
h)`` (the tile-row slab of the sharded paths in ``parallel/``): the centres
are binned in slab rows; the ``"torch"`` route adds ``row0`` back to each
pixel's y inside the alpha, and the ``"cuda"`` route folds the shift into
the primed y rows (``slab_primed_columns``), so the kernels read slab-row
pixels unchanged.
"""

from __future__ import annotations

import math

import torch

from .camera import Camera
from .config import DEFAULT_CONFIG, RenderConfig
from .ops.binning import bin_gaussians_to_tiles, num_tiles
from .ops.projection import apply_lens, clip, project_gaussians
from .ops.rasterization import RasterAux, _assemble, rasterize_torch_generic
from .ops.sh import sh_to_color
from .ops.slice_cuda import segment_slice_gather
from .ops.surfel_cuda import (
    gather_surfel_tile_data,
    primed_surfel_columns,
    raster_surfel_tiles,
    slab_primed_columns,
)
from .render import RenderAux, slab_means2d

_FILTER_SIGMA2 = 0.5  # (sqrt(2)/2)^2: the paper's screen-space low-pass
_TINY_LOG_SCALE = -13.8  # exp() ~ 1e-6: the disk's "thickness" for binning


def _rotate_rows(vx, vy, vz, R):
    """(R @ v) for per-surfel column vectors given as three (N,) columns."""
    return (
        vx * R[0, 0] + vy * R[0, 1] + vz * R[0, 2],
        vx * R[1, 0] + vy * R[1, 1] + vz * R[1, 2],
        vx * R[2, 0] + vy * R[2, 1] + vz * R[2, 2],
    )


def _tangent_axes(quats):
    """The first two rotation-matrix columns (the disk's tangent axes) of
    the wxyz quaternions, normalised first, as three (N,) columns each."""
    norm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    q = quats / torch.clamp(norm, min=1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    tu = (1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y))
    tv = (2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x))
    return tu, tv


def surfel_alpha_columns(means3d, scales, quats, opacities, camera: Camera) -> tuple:
    """12 per-surfel (N,) columns [qc(3), a(3), b(3), c2(2), opacity]:
    the camera-frame centre, the scaled camera-frame tangent axes, the
    projected centre in pixels and the opacity. ``scales`` is (N, 2) or
    (N, 3) log scales (a third is ignored). For ortho the projected centre
    is the affine image of qc, for fisheye the lens map of its direction."""
    tu, tv = _tangent_axes(quats)
    su = torch.exp(scales[:, 0])
    sv = torch.exp(scales[:, 1])
    qcx, qcy, qcz = _rotate_rows(means3d[:, 0], means3d[:, 1], means3d[:, 2], camera.R)
    qcx, qcy, qcz = qcx + camera.T[0], qcy + camera.T[1], qcz + camera.T[2]
    ax, ay, az = _rotate_rows(*tu, camera.R)
    bx, by, bz = _rotate_rows(*tv, camera.R)
    if camera.camera_model == "ortho":
        c2x = camera.fx * qcx + camera.cx
        c2y = camera.fy * qcy + camera.cy
    else:
        z = torch.clamp(qcz, min=1e-6)
        xn, yn = qcx / z, qcy / z
        if camera.camera_model == "fisheye":
            xn, yn = apply_lens(camera, xn, yn)
        c2x = camera.fx * xn + camera.cx
        c2y = camera.fy * yn + camera.cy
    return (qcx, qcy, qcz, su * ax, su * ay, su * az, sv * bx, sv * by, sv * bz,
            c2x, c2y, opacities)


def surfel_alpha_data(means3d, scales, quats, opacities, camera: Camera) -> torch.Tensor:
    """(N, 12) per-surfel rows [qc(3), a(3), b(3), center2d(2), opacity]."""
    return torch.stack(surfel_alpha_columns(means3d, scales, quats, opacities, camera),
                       dim=-1)


def oriented_normal_columns(columns) -> tuple:
    """(nx, ny, nz) unit normal columns from the 12 surfel columns: the
    cross product of the camera-frame tangent axes, flipped toward the
    viewer."""
    ax, ay, az, bx, by, bz = columns[3:9]
    nx = ay * bz - az * by
    ny = az * bx - ax * bz
    nz = ax * by - ay * bx
    inv = 1.0 / torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz), min=1e-12)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    flip = nz > 0
    return (torch.where(flip, -nx, nx), torch.where(flip, -ny, ny),
            torch.where(flip, -nz, nz))


def _invert_equidistant(camera: Camera, xd, yd):
    """The inverse of ``apply_lens``'s fisheye map: distorted normalised
    coordinates -> undistorted ones (the pixel's ray is (xn, yn, 1)).
    theta solves theta_d = theta (1 + k1 th^2 + ... + k4 th^8) by 8 Newton
    steps (exact in one for the ideal k = 0 lens), clipped to [0, pi/2 -
    1e-3]; then r = tan(theta). On the optical axis the input is sanitised
    (double where) so the scale's 0/0 makes no NaN gradient."""
    k1, k2, k3, k4 = (camera.dist[..., i] for i in range(4))
    rd2 = xd * xd + yd * yd
    on_axis = rd2 < 1e-12
    rd = torch.sqrt(torch.where(on_axis, torch.ones_like(rd2), rd2))  # = theta_d
    th = rd
    for _ in range(8):
        th2 = th * th
        poly = 1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
        dpoly = 1.0 + th2 * (3.0 * k1 + th2 * (5.0 * k2 + th2 * (7.0 * k3 + th2 * 9.0 * k4)))
        th = th - (th * poly - rd) / torch.maximum(dpoly, torch.full_like(dpoly, 1e-6))
    th = clip(th, 0.0, 0.5 * math.pi - 1e-3)
    scale = torch.where(on_axis, torch.ones_like(rd), torch.tan(th) / rd)
    return xd * scale, yd * scale


def _surfel_alphas(px, py, d, valid, camera: Camera, config: RenderConfig,
                   with_depth: bool = False):
    """Alphas (..., P, K) of K surfels at P pixels, for the camera's rays
    (see the module docstring).

    px, py: (..., P); d: (..., K, 12) rows of ``surfel_alpha_data``;
    valid: (..., K). With ``with_depth`` also returns (..., P, K, 2)
    per-pixel values [z, z^2] of the ray/disk intersection depth, falling
    back to the centre depth where the low-pass filter dominates or the ray
    runs parallel to the disk.
    """
    qc, a, b = d[..., None, :, 0:3], d[..., None, :, 3:6], d[..., None, :, 6:9]
    c2, op = d[..., None, :, 9:11], d[..., None, :, 11]
    xn = (px[..., :, None] - camera.cx) / camera.fx  # (..., P, 1)
    yn = (py[..., :, None] - camera.cy) / camera.fy
    if camera.camera_model == "fisheye":
        xn, yn = _invert_equidistant(camera, xn, yn)

    if camera.camera_model == "ortho":
        shape = torch.broadcast_shapes(xn.shape, a[..., 0].shape)
        A11 = a[..., 0].expand(shape)  # (..., P, K)
        A12 = b[..., 0].expand(shape)
        A21 = a[..., 1].expand(shape)
        A22 = b[..., 1].expand(shape)
        r1 = xn - qc[..., 0]
        r2 = yn - qc[..., 1]
    else:
        A11 = a[..., 0] - xn * a[..., 2]  # (..., P, K)
        A12 = b[..., 0] - xn * b[..., 2]
        A21 = a[..., 1] - yn * a[..., 2]
        A22 = b[..., 1] - yn * b[..., 2]
        r1 = xn * qc[..., 2] - qc[..., 0]
        r2 = yn * qc[..., 2] - qc[..., 1]

    det = A11 * A22 - A12 * A21
    ok = torch.abs(det) > 1e-9  # the ray is not parallel to the disk
    det_safe = torch.where(ok, det, torch.ones_like(det))  # no NaN gradients
    u = (r1 * A22 - r2 * A12) / det_safe
    v = (A11 * r2 - A21 * r1) / det_safe
    s2 = torch.clamp(u * u + v * v, max=1e4)
    g_surf = torch.where(ok, torch.exp(-0.5 * s2), torch.zeros_like(s2))

    dx = px[..., :, None] - c2[..., 0]
    dy = py[..., :, None] - c2[..., 1]
    g_filt = torch.exp(-(dx * dx + dy * dy) / (2.0 * _FILTER_SIGMA2))
    g = torch.maximum(g_surf, g_filt)  # the paper's low-pass max

    alpha = torch.clamp(op * g, max=config.max_alpha)
    keep = valid[..., None, :] & (alpha >= config.alpha_threshold)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    if not with_depth:
        return alpha
    z_surf = qc[..., 2] + u * a[..., 2] + v * b[..., 2]
    use_surf = ok & (g_surf >= g_filt)
    z = torch.where(use_surf, z_surf, qc[..., 2])
    return alpha, torch.stack([z, z * z], dim=-1)


def bin_surfels(means3d, scales, quats, opacities, camera: Camera,
                config: RenderConfig, viewport_rows=None):
    """Tile binning of the surfels: the 3DGS projection and binning of the
    flattened gaussian (log-scales ``(s_u, s_v, -13.8)``), with the
    surviving radii widened to the low-pass filter's support, where the
    filter keeps alpha above the threshold: ceil(sqrt(2 * 0.5 *
    log(opacity / threshold))) px. (The EWA bound of an edge-on disk's thin
    axis is narrower.) With ``viewport_rows=(row0, h)`` the tiles are those
    of the slab's h rows."""
    N = means3d.shape[0]
    scales3 = torch.cat([scales[:, :2], torch.full((N, 1), _TINY_LOG_SCALE,
                                                   dtype=scales.dtype, device=scales.device)],
                        dim=-1)
    proj = project_gaussians(means3d, scales3, quats, opacities, camera, config)
    safe_op = torch.clamp(opacities, min=config.alpha_threshold)
    filter_r = torch.ceil(torch.sqrt(
        2.0 * _FILTER_SIGMA2 * torch.log(safe_op / config.alpha_threshold)
    )).to(proj.radii.dtype)
    radii = torch.where(proj.radii > 0, torch.maximum(proj.radii, filter_r[:, None]),
                        proj.radii)
    means2d, out_h = slab_means2d(proj.means2d, camera.H, viewport_rows, config)
    return bin_gaussians_to_tiles(means2d, radii, proj.depths, out_h, camera.W, config)


def pack_surfel_tiles(means3d, scales, quats, opacities, colors, camera: Camera, binning,
                      config: RenderConfig, maps: bool, row0=0):
    """The ``"cuda"`` route's input to the surfel blend kernels: (pdata,
    counts), the packed slot table (16 rows, 18 with the ``maps``) of the
    tiles' first ``tile_capacity`` slots, cut from the binning by B5, and
    the (n_tiles,) int32 counts of slots to blend. ``row0``: the first
    image row of a slab binning (``viewport_rows``)."""
    if colors.shape[-1] != 3:
        raise ValueError(f"the surfel kernels blend 3 colour channels, got {colors.shape[-1]}")
    cap = config.tile_capacity
    ranges = binning.tile_ranges.reshape(-1, 2)
    counts = torch.clamp(ranges[:, 1] - ranges[:, 0], 0, cap).to(torch.int32)
    slot_gids = segment_slice_gather(binning.gaussian_ids, ranges[:, 0].contiguous(), cap)
    cols = surfel_alpha_columns(means3d, scales, quats, opacities, camera)
    pcols = list(primed_surfel_columns(cols, camera))
    if row0:
        pcols = slab_primed_columns(pcols, row0)
    pcols += [colors[:, c] for c in range(3)]
    if maps:
        pcols += list(oriented_normal_columns(cols))
    return gather_surfel_tile_data(pcols, slot_gids, counts), counts


def render_surfels(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 2) or (N, 3) log scales
    quats: torch.Tensor,  # (N, 4) wxyz
    opacities: torch.Tensor,  # (N,)
    features: torch.Tensor,  # (N, 3) RGB or (N, K, 3) SH
    camera: Camera,
    sh_degree: int | None = None,
    background_color=None,
    config: RenderConfig = DEFAULT_CONFIG,
    return_aux: bool = False,
    return_depth: bool = False,
    return_normals: bool = False,
    return_distortion: bool = False,
    viewport_rows=None,
):
    """Render 2D gaussian surfels to an (H, W, 3) image.

    Extra outputs, appended in this order with the ``RenderAux`` last:
      - ``return_depth``: the (H, W) blended ray/disk intersection depth
        (premultiplied: divide by ``1 - final_transmittance``);
      - ``return_normals``: the (H, W, 3) blended camera-frame normals
        (premultiplied);
      - ``return_distortion``: the (H, W) depth-distortion map
        ``2 (alpha sum(w z^2) - sum(w z)^2)``, the paper's regulariser.
    """
    if config.raster_impl not in ("torch", "cuda"):
        raise ValueError(f"Unknown raster_impl: {config.raster_impl!r}")
    want_vals = return_depth or return_distortion
    want_maps = want_vals or return_normals
    if config.raster_impl == "cuda" and (
            camera.camera_model == "fisheye" or (camera.camera_model == "ortho" and want_maps)):
        # The kernels read the primed z rows as the intersection depth too,
        # which ortho priming sets to (1, 0, 0); and the fisheye needs a
        # per-pixel lens inversion they do not make.
        raise NotImplementedError(
            f"camera_model={camera.camera_model!r} with maps={want_maps} requires "
            "raster_impl='torch' for surfels (cuda takes pinhole, and ortho without maps)")
    if sh_degree is None:
        colors = features
    else:
        colors = sh_to_color(features, means3d, camera.position, sh_degree)
    if background_color is None:
        background = torch.zeros((3,), dtype=features.dtype, device=features.device)
    else:
        background = torch.as_tensor(background_color, dtype=features.dtype,
                                     device=features.device)

    binning = bin_surfels(means3d, scales, quats, opacities, camera, config, viewport_rows)
    row0, H = (0, camera.H) if viewport_rows is None else viewport_rows
    W = camera.W
    if config.raster_impl == "cuda":
        ts = config.tile_size
        th, tw = num_tiles(H, W, ts)
        pdata, counts = pack_surfel_tiles(means3d, scales, quats, opacities, colors, camera,
                                          binning, config, want_maps, row0)
        out = raster_surfel_tiles(pdata, counts, ts, tw, config, want_maps)
        # Channel-major (n_tiles, oc, P): rgb(0:3), pad, T(4); with the
        # maps rgb(0:3), normals(3:6), m1(6), m2(7), T(8).
        T_tiles = out[:, 8 if want_maps else 4, :]
        image = _assemble(
            (out[:, :3, :] + T_tiles[:, None, :] * background[None, :, None]).to(colors.dtype),
            th, tw, ts, H, W)
        final_T = _assemble(T_tiles[:, None, :], th, tw, ts, H, W)[..., 0]
        if want_maps:
            normals = _assemble(out[:, 3:6, :], th, tw, ts, H, W)
            m1 = _assemble(out[:, 6:7, :], th, tw, ts, H, W)[..., 0]
            m2 = _assemble(out[:, 7:8, :], th, tw, ts, H, W)[..., 0]
        ranges = binning.tile_ranges.reshape(-1, 2)
        raster_aux = RasterAux(
            final_transmittance=final_T,
            tile_overflow=torch.clamp(ranges[:, 1] - ranges[:, 0] - config.tile_capacity,
                                      min=0).sum().to(torch.int32))
    else:
        data = surfel_alpha_data(means3d, scales, quats, opacities, camera)
        channels = [colors]
        if return_normals:
            cols = tuple(data[:, i] for i in range(12))
            channels.append(torch.stack(oriented_normal_columns(cols), dim=-1).to(colors.dtype))
        colors_ext = torch.cat(channels, dim=-1)
        background_ext = torch.cat(
            [background, background.new_zeros((colors_ext.shape[-1] - 3,))])

        def alpha_fn(px, py, safe, valid):
            # py arrives in slab rows; the response is defined in image rows.
            return _surfel_alphas(px, py + row0, data[safe], valid, camera, config,
                                  with_depth=want_vals)

        img, raster_aux = rasterize_torch_generic(
            alpha_fn, means3d.shape[0], colors_ext, background_ext, binning, H, W, config,
            n_pixel_values=2 if want_vals else 0)
        # Channels: rgb(3), normals(3, if asked for), then m1, m2.
        nc = 6 if return_normals else 3
        image = img[..., :3]
        normals = img[..., 3:6] if return_normals else None
        m1 = img[..., nc] if want_vals else None
        m2 = img[..., nc + 1] if want_vals else None

    ordered = [image]
    if return_depth:
        ordered.append(m1)
    if return_normals:
        ordered.append(normals)
    if return_distortion:
        alpha_map = 1.0 - raster_aux.final_transmittance
        ordered.append(2.0 * (alpha_map * m2 - m1 * m1))
    if return_aux:
        ordered.append(RenderAux(binning=binning.aux, raster=raster_aux))
    return ordered[0] if len(ordered) == 1 else tuple(ordered)


def backproject_normals_from_depth(expected_depth: torch.Tensor, camera: Camera,
                                   row0=0, ghost_rows=None) -> torch.Tensor:
    """(H, W, 3) camera-frame normals from the depth map's local geometry:
    each pixel backprojected to ``z (xn, yn, 1)``, the normalised cross
    product of the screen-space finite differences, oriented toward the
    viewer (n_z < 0).

    ``row0``: the absolute image row of the map's first row (a tile-row
    slab's offset). ``ghost_rows``: optional ((W,), (W,)) expected-depth
    rows just above and below the map (a sharded caller's halo); without
    them reflective ghosts ``2 p0 - p1`` are used, which makes the centred
    difference at the edges the one-sided one.
    """
    H, W = expected_depth.shape
    d = expected_depth
    top = 2.0 * d[0] - d[1] if ghost_rows is None else ghost_rows[0]
    bot = 2.0 * d[-1] - d[-2] if ghost_rows is None else ghost_rows[1]
    d_pad = torch.cat([top[None, :], d, bot[None, :]], dim=0)
    xs = torch.arange(W, dtype=d.dtype, device=d.device) + 0.5 - camera.cx
    ys = (torch.arange(-1, H + 1, dtype=d.dtype, device=d.device) + 0.5
          + torch.as_tensor(row0, dtype=d.dtype, device=d.device) - camera.cy)
    xn = xs[None, :] / camera.fx
    yn = ys[:, None] / camera.fy
    p = torch.stack([d_pad * xn, d_pad * yn, d_pad], dim=-1)  # (H + 2, W, 3)
    dpdx = torch.gradient(p[1:-1], dim=1)[0]
    dpdy = 0.5 * (p[2:] - p[:-2])  # centred everywhere (ghost-padded)
    n = torch.linalg.cross(dpdx, dpdy, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    return torch.where(n[..., 2:3] > 0, -n, n)


def expected_depth_map(depth, final_transmittance, alpha_floor: float = 0.5):
    """(edepth, covered): the depth over the coverage where the coverage
    exceeds ``alpha_floor``, and a dummy depth of 1 elsewhere, so that no
    division or normalisation makes a NaN."""
    alpha = 1.0 - final_transmittance
    covered = alpha > alpha_floor
    safe_a = torch.where(covered, torch.clamp(alpha, min=1e-6), torch.ones_like(alpha))
    return torch.where(covered, depth, torch.ones_like(depth)) / safe_a, covered


def normal_consistency_terms(depth, normal, final_transmittance, camera: Camera,
                             alpha_floor: float = 0.5, row0=0, ghost_rows=None):
    """(numerator, denominator) of the normal-consistency regulariser: the
    alpha-weighted ``1 - n_render . n_depth`` summed over covered pixels,
    and the sum of those weights. The depth normals carry no gradient."""
    alpha = 1.0 - final_transmittance
    edepth, covered = expected_depth_map(depth, final_transmittance, alpha_floor)
    safe_a = torch.where(covered, torch.clamp(alpha, min=1e-6), torch.ones_like(alpha))
    unit_z = torch.tensor([0.0, 0.0, -1.0], dtype=normal.dtype, device=normal.device)
    # Replace the inputs (not the outputs) at uncovered pixels, where the
    # blended normal is zero and normalising it would make 0/0 gradients.
    n_render = torch.where(covered[..., None], normal / safe_a[..., None], unit_z)
    n_render = n_render / torch.clamp(torch.linalg.norm(n_render, dim=-1, keepdim=True),
                                      min=1e-12)
    n_depth = backproject_normals_from_depth(edepth, camera, row0=row0, ghost_rows=ghost_rows)
    w = torch.where(covered, alpha, torch.zeros_like(alpha))
    dots = torch.sum(n_render * n_depth.detach(), dim=-1)
    return torch.sum(w * (1.0 - dots)), torch.sum(w)


def normal_consistency_loss(depth, normal, final_transmittance, camera: Camera,
                            alpha_floor: float = 0.5) -> torch.Tensor:
    """The 2DGS paper's normal-consistency regulariser, ``num / max(den,
    1)`` of ``normal_consistency_terms``: pass the depth and normals of
    ``render_surfels(..., return_depth=True, return_normals=True)``."""
    num, den = normal_consistency_terms(depth, normal, final_transmittance, camera,
                                        alpha_floor)
    return num / torch.clamp(den, min=1.0)
