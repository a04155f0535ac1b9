"""Trainable gaussian splatting: parameters, losses, optimizers, train step.

Counterpart of the single-device core of ``mojosplat_tpu.train``. Raw
(pre-activation) parameters are trained: opacities as logits
(``opacities_raw``), scales in log space, quaternions normalised inside the
projection. Parameters are a dict of leaf tensors (or an
``nn.ParameterDict``); a batch of views is a list of ``Camera``s, the
counterpart of the reference's vmapped camera batch.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from .camera import Camera
from .config import DEFAULT_CONFIG, RenderConfig
from .densify import DensifyState, accumulate_stats
from .ops.sh import num_sh_bases
from .params import activate  # also train.activate, as in the reference
from .parallel.sharding import (
    Mesh,
    all_gather_parts,
    all_reduce_sum,
    check_slab_divisibility,
    local_cameras,
    render_slabs,
)
# zero1_rows: also train.zero1_rows, the reference's train._zero1_rows.
from .parallel.zero1 import all_reduce_grads, clear_grads, replicated_update, zero1_rows
from .render import render_gaussians
from .surfel import expected_depth_map, normal_consistency_terms, render_surfels


def init_gaussians(
    n: int,
    sh_degree: int | None = None,
    position_scale: float = 2.0,
    log_scale_mean: float = -2.0,
    *,
    generator: torch.Generator,
    device: torch.device | str,
) -> dict[str, torch.Tensor]:
    """Random gaussian cloud with the reference's distribution: randn * 2
    means, log-scales around -2, random unit quats, logits around 1, and
    uniform colours (or a band-0 SH colour in [-0.5, 0.5)). The numbers
    differ from the reference's for the same seed (another generator)."""
    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    means3d = randn(n, 3) * position_scale
    scales = log_scale_mean + randn(n, 3) * 0.3
    quats = randn(n, 4)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacities_raw = randn(n) + 1.0
    if sh_degree is None:
        features = rand(n, 3)
    else:
        features = torch.zeros((n, num_sh_bases(sh_degree), 3), device=device)
        features[:, 0, :] = rand(n, 3) - 0.5
    return dict(means3d=means3d, scales=scales, quats=quats,
                opacities_raw=opacities_raw, features=features)


def l2_image_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((rendered - target) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB for [0, 1] images (eps-guarded so a
    perfect fit reports ~120 dB instead of inf)."""
    return -10.0 * torch.log10(torch.mean((a - b) ** 2) + 1e-12)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    """The normalised 1D Gaussian; the SSIM window is its outer product."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM between two (..., H, W, C) images in [0, 1]: the 11x11
    Gaussian-window SSIM of the 3DGS training recipe, with zero padding
    ("SAME").

    Each blur is the window's two 1D passes (the window is separable):
    22 products a pixel in place of 121, and as close to the exact blur as
    the reference's 2D convolution on the CPU (one 2D pass on the CPU lands
    2-3x farther). The variance estimate blur(x^2) - mx^2 cancels on smooth
    regions, so the blurs' rounding shows in the result. They run in full
    f32: cuDNN would run them in TF32 by default, and the variance would
    then lose enough digits to push SSIM past 1 on flat regions (the
    reference met this on the TPU).
    """
    c1, c2 = 0.01**2, 0.03**2
    g = _gaussian_window(window_size, 1.5, a.device).to(a.dtype)
    rows, cols = g.reshape(1, 1, -1, 1), g.reshape(1, 1, 1, -1)
    pad = window_size // 2
    H, W, C = a.shape[-3:]
    x = a.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)
    y = b.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)

    def blur(img):
        img = torch.nn.functional.conv2d(img, rows, padding=(pad, 0))
        return torch.nn.functional.conv2d(img, cols, padding=(0, pad))

    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        mx, my = blur(x), blur(y)
        mxx, myy, mxy = mx * mx, my * my, mx * my
        sx = blur(x * x) - mxx
        sy = blur(y * y) - myy
        sxy = blur(x * y) - mxy
    s = ((2 * mxy + c1) * (2 * sxy + c2)) / ((mxx + myy + c1) * (sx + sy + c2))
    return torch.mean(s)


def dssim_l1_loss(rendered: torch.Tensor, target: torch.Tensor,
                  ssim_weight: float = 0.2) -> torch.Tensor:
    """The standard 3DGS photometric loss: (1 - w) * L1 + w * (1 - SSIM).

    Where rendered == target exactly (an empty background pixel against a
    black target), |x| takes the reference's subgradient, 1 (``jnp.abs``);
    ``torch.abs`` would take 0, and an exposure bias or bilateral grid fed
    by such pixels would get another gradient than the reference's.
    """
    d = rendered - target
    l1 = torch.mean(torch.where(d < 0, -d, d))
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(rendered, target))


def make_optimizer(params: Mapping[str, torch.Tensor], lr: float = 1e-2) -> torch.optim.Adam:
    """Adam over every parameter (the reference's ``optax.adam(lr)``)."""
    return torch.optim.Adam(list(params.values()), lr=lr)


class selective_adam(torch.optim.Optimizer):
    """Adam that freezes rows whose gradient is exactly zero this step.

    The reference's ``selective_adam``: a gaussian culled or binned outside
    every rendered tile gets an exactly-zero gradient, and plain Adam would
    still decay its moments and move it by m / (sqrt(v) + eps) from stale
    moments. Here the rows (along the leading axis) whose gradient is all
    zero keep their moments AND values. The step count advances for every
    parameter at every step, as in the reference, so bias correction is
    global. Same update as ``optax.adam``:
    ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.
    """

    def __init__(self, params, lr: float = 1e-2, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure: Callable | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            group["step"] = count = group.get("step", 0) + 1
            bc1 = 1.0 - b1**count
            bc2 = 1.0 - b2**count
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                visible = (g != 0).reshape(g.shape[0], -1).any(dim=1)
                rows = visible.reshape(visible.shape + (1,) * (g.ndim - 1))
                m_new = b1 * m + (1.0 - b1) * g
                v_new = b2 * v + (1.0 - b2) * g * g
                update = group["lr"] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + group["eps"])
                m.copy_(torch.where(rows, m_new, m))
                v.copy_(torch.where(rows, v_new, v))
                p.sub_(torch.where(rows, update, torch.zeros_like(update)))
        return loss


def train_step(
    params: Mapping[str, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    cameras: Sequence[Camera],
    targets: torch.Tensor,  # (B, H, W, C)
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    loss_extra: Callable[[Mapping[str, torch.Tensor]], torch.Tensor] | None = None,
) -> torch.Tensor:
    """One optimizer step on the L2 loss over a batch of views; returns the
    loss (detached). ``params`` are the raw leaf tensors the optimizer
    holds; ``loss_extra(params) -> scalar`` adds a regulariser to the image
    loss. The views are rendered one after another and their losses
    averaged, as the reference's vmapped render and mean do."""
    if len(cameras) != targets.shape[0]:
        raise ValueError(f"{len(cameras)} cameras for {targets.shape[0]} targets")
    optimizer.zero_grad(set_to_none=True)
    p = activate(params)
    loss = 0.0
    for cam, target in zip(cameras, targets):
        img = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"],
            cam, sh_degree=sh_degree, config=config,
        )
        loss = loss + l2_image_loss(img, target)
    loss = loss / len(cameras)
    if loss_extra is not None:
        loss = loss + loss_extra(params)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_step_with_densify_stats(
    params: Mapping[str, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    densify_state: DensifyState,
    cameras: Sequence[Camera],
    targets: torch.Tensor,  # (B, H, W, C)
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    absgrad: bool = False,
) -> tuple[DensifyState, torch.Tensor]:
    """One optimizer step on the L2 loss that also accumulates the
    view-space gradient statistics of density control (``densify.py``).
    Returns (the new ``DensifyState``, the loss, detached).

    A zero (N, 2) input shared by every view takes the statistic's
    gradient: ``means2d_offset`` (the signed view-space gradient), or with
    ``absgrad`` the ``absgrad_sink`` (the sum over tiles of its absolute
    per-tile value, AbsGS; use a 2-4x higher ``grad_threshold``). The views
    are rendered one after another and stacked under one
    ``l2_image_loss``. A gaussian counts as seen when some view's
    projection in the render gives it a radius.
    """
    if len(cameras) != targets.shape[0]:
        raise ValueError(f"{len(cameras)} cameras for {targets.shape[0]} targets")
    n = params["means3d"].shape[0]
    optimizer.zero_grad(set_to_none=True)
    sink = torch.zeros((n, 2), dtype=torch.float32, device=params["means3d"].device,
                       requires_grad=True)
    p = activate(params)
    imgs, visible = [], torch.zeros((n,), dtype=torch.bool, device=sink.device)
    for cam in cameras:
        img, aux = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam,
            sh_degree=sh_degree, config=config, return_aux=True,
            **{"absgrad_sink" if absgrad else "means2d_offset": sink},
        )
        imgs.append(img)
        visible |= aux.visible
    loss = l2_image_loss(torch.stack(imgs), targets)
    loss.backward()
    densify_state = accumulate_stats(densify_state, sink.grad, visible)
    optimizer.step()
    return densify_state, loss.detach()


def surfel_loss(
    params: Mapping[str, torch.Tensor],
    cameras: Sequence[Camera],
    targets: torch.Tensor,  # (B, H, W, 3)
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    normal_weight: float = 0.0,
    distortion_weight: float = 0.0,
) -> torch.Tensor:
    """The 2DGS training loss of the raw ``params`` over a batch of views:
    ``sum (img - target)^2 / targets.numel()``, plus
    ``distortion_weight * sum(distortion) / (targets.numel() // 3)``, plus
    ``normal_weight * sum(num) / max(sum(den), 1)`` of
    ``normal_consistency_terms``, each sum taken over all views before the
    ratio (the reference's ``train_step_sharded_surfel`` loss). Every view
    renders its depth, normal and distortion maps."""
    if len(cameras) != targets.shape[0]:
        raise ValueError(f"{len(cameras)} cameras for {targets.shape[0]} targets")
    p = activate(params)
    photo = dist = num = den = 0.0
    for cam, target in zip(cameras, targets):
        img, depth, normal, distortion, aux = render_surfels(
            p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam,
            sh_degree=sh_degree, config=config, return_aux=True, return_depth=True,
            return_normals=True, return_distortion=True,
        )
        n, d = normal_consistency_terms(depth, normal, aux.raster.final_transmittance, cam)
        photo = photo + torch.sum((img - target) ** 2)
        dist = dist + torch.sum(distortion)
        num, den = num + n, den + d
    loss = photo / targets.numel()
    if distortion_weight:
        loss = loss + distortion_weight * dist / (targets.numel() // 3)
    if normal_weight:
        loss = loss + normal_weight * num / torch.clamp(den, min=1.0)
    return loss


def train_step_surfel(
    params: Mapping[str, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    cameras: Sequence[Camera],
    targets: torch.Tensor,  # (B, H, W, 3)
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    normal_weight: float = 0.0,
    distortion_weight: float = 0.0,
) -> torch.Tensor:
    """One optimizer step of 2DGS (surfel) training on ``surfel_loss``, with
    the paper's distortion and normal-consistency regularisers; returns the
    loss (detached).

    The single-device counterpart of ``train_step_sharded_surfel``, with
    the same global loss.
    """
    optimizer.zero_grad(set_to_none=True)
    loss = surfel_loss(params, cameras, targets, sh_degree, config, normal_weight,
                       distortion_weight)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_step_sharded(
    params: Mapping[str, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    cameras: Sequence[Camera],  # the global batch of B cameras, the same on every rank
    targets: torch.Tensor,  # this rank's (B / n_data, H / n_tile, W, C) block
    mesh: Mesh,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    loss_extra: Callable[[Mapping[str, torch.Tensor]], torch.Tensor] | None = None,
    zero1: Mapping[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One training step over a (``"data"``, ``"tile"``) mesh; returns the
    global loss (detached).

    Each rank renders its cameras' tile-row slab and differentiates the
    local sum of squares; the parameter gradients are all-reduced over the
    mesh and divided by the global element count, so every rank applies
    the same update to its replica of the parameters.
    ``sharding.batch_block`` cuts a rank's ``targets`` from the full batch.

    ``loss_extra(params) -> scalar`` adds a regulariser (e.g.
    ``densify.mcmc_regularization``): the parameters are replicated, so it
    is evaluated on every rank and not reduced over the mesh.

    ``zero1``: this rank's ZeRO-1 shard (``zero1_rows(params, mesh)``),
    the leaves ``optimizer`` holds. After the all-reduce each rank steps
    only its 1/n slice of every parameter's rows (the moments of that
    slice live on it alone) and the slices are all-gathered back, for the
    moments' memory cut by n; equal to the replicated update. None:
    ``optimizer`` holds ``params`` and steps them on every rank.
    """
    n_tile = mesh.shape["tile"]
    slab_h = check_slab_divisibility(cameras[0].H, n_tile, config)
    row0 = mesh.index("tile") * slab_h
    cams = local_cameras(cameras, mesh)
    if len(cams) != targets.shape[0]:
        raise ValueError(f"{len(cams)} local cameras for {targets.shape[0]} targets")
    clear_grads(params, optimizer)
    imgs = render_slabs(activate(params), cams, row0, slab_h, sh_degree, None, config)
    local = torch.sum((imgs - targets) ** 2)
    local.backward()
    denom = float(targets.numel() * mesh.size)  # the global element count
    loss = local.detach().clone()
    dist.all_reduce(loss, group=mesh.group)
    all_reduce_grads(params, mesh)
    for p in params.values():
        p.grad.div_(denom)
    loss = loss / denom
    if loss_extra is not None:
        reg = loss_extra(params)
        reg.backward()  # adds to the reduced gradients
        loss = loss + reg.detach()
    replicated_update(params, optimizer, mesh, zero1)
    return loss


def _halo_rows(ed: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The expected-depth rows just outside this rank's slabs, (B_local, W)
    each: the last row of the slab above and the first row of the slab
    below, by one all-gather of every slab's edge rows along the tile axis;
    the image's own edges take reflective ghosts (2 d0 - d1)."""
    n_tile, t = mesh.shape["tile"], mesh.index("tile")
    edges = torch.stack([ed[:, 0], ed[:, -1]], dim=1)  # (B_local, 2, W)
    parts = all_gather_parts(edges, mesh.axis_groups["tile"])
    top = 2.0 * ed[:, 0] - ed[:, 1] if t == 0 else parts[t - 1][:, 1]
    bot = 2.0 * ed[:, -1] - ed[:, -2] if t == n_tile - 1 else parts[t + 1][:, 0]
    return top, bot


def train_step_sharded_surfel(
    params: Mapping[str, torch.Tensor],
    optimizer: torch.optim.Optimizer,
    cameras: Sequence[Camera],  # the global batch of B cameras, the same on every rank
    targets: torch.Tensor,  # this rank's (B / n_data, H / n_tile, W, 3) block
    mesh: Mesh,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    normal_weight: float = 0.0,
    distortion_weight: float = 0.0,
    zero1: Mapping[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """2DGS (surfel) training step over a (``"data"``, ``"tile"``) mesh,
    with the depth-distortion and normal-consistency regularisers computed
    per slab; returns the global loss (detached), ``surfel_loss`` of the
    whole batch.

    Each rank renders its cameras' slab with the maps. The normal
    stencil's finite differences need one expected-depth row from each
    neighbouring slab: a halo exchange (``_halo_rows``) brings it, and the
    image's edges take the single-device render's reflective ghosts. The
    four loss terms are summed over the mesh inside the differentiated
    loss (``all_reduce_sum``, whose backward all-reduces the cotangent, as
    the reference's psum transposes), then the parameter gradients are
    all-reduced and every rank applies the same update.

    As in the reference, the gradient comes out n_dev = n_data * n_tile
    times the single-device gradient of the same loss: the cotangent is
    summed once by the reduction's backward and again by the gradient
    all-reduce. With SGD at lr 1 on the CPU, the reference's sharded
    gradient is 2.000x the single-device one on a (1, 2) mesh (ROADMAP.md,
    Queue C, "Open in the reference"); this port reproduces it for parity.
    ``zero1``: as in ``train_step_sharded``.
    """
    n_tile = mesh.shape["tile"]
    slab_h = check_slab_divisibility(cameras[0].H, n_tile, config)
    row0 = mesh.index("tile") * slab_h
    cams = local_cameras(cameras, mesh)
    if len(cams) != targets.shape[0]:
        raise ValueError(f"{len(cams)} local cameras for {targets.shape[0]} targets")
    npix_global = targets.numel() * mesh.size
    clear_grads(params, optimizer)

    outs = render_slabs(activate(params), cams, row0, slab_h, sh_degree, None, config,
                        primitive="2dgs", return_aux=True, return_depth=True,
                        return_normals=True, return_distortion=True)
    with torch.no_grad():
        ed = torch.stack([expected_depth_map(depth, aux.raster.final_transmittance)[0]
                          for _, depth, _, _, aux in outs])
        ghost_top, ghost_bot = _halo_rows(ed, mesh)
    photo = dist_sum = num = den = 0.0
    for b, ((img, depth, normal, distortion, aux), cam) in enumerate(zip(outs, cams)):
        n_b, d_b = normal_consistency_terms(depth, normal, aux.raster.final_transmittance, cam,
                                            row0=row0, ghost_rows=(ghost_top[b], ghost_bot[b]))
        photo = photo + torch.sum((img - targets[b]) ** 2)
        dist_sum = dist_sum + torch.sum(distortion)
        num, den = num + n_b, den + d_b
    terms = all_reduce_sum(torch.stack([photo, dist_sum, num, den]), mesh.group)
    photo, dist_sum, num, den = terms.unbind()
    loss = photo / npix_global
    if distortion_weight:
        loss = loss + distortion_weight * dist_sum / (npix_global // 3)
    if normal_weight:
        loss = loss + normal_weight * num / torch.clamp(den, min=1.0)
    loss.backward()
    all_reduce_grads(params, mesh)
    replicated_update(params, optimizer, mesh, zero1)
    return loss.detach()


def sparse_depth_loss(
    depth: torch.Tensor,  # (H, W) accumulated (alpha-weighted) depth
    alpha: torch.Tensor,  # (H, W) accumulated opacity = 1 - final transmittance
    uv: torch.Tensor,  # (K, 2) pixel coordinates of the SfM observations
    depth_gt: torch.Tensor,  # (K,) camera-frame z of the triangulated points
    mask: torch.Tensor,  # (K,) bool, valid targets
    eps: float = 1e-6,
) -> torch.Tensor:
    """L1 disparity loss at sparse SfM keypoints (gsplat's depth loss):
    anchors the rendered geometry to the COLMAP triangulation. Targets come
    from ``utils.colmap.sparse_depth_targets``.

    The rendered disparity is ``alpha / (depth + eps)``: 1 / expected depth,
    but smooth and select-free, so an uncovered pixel (alpha -> 0) adds a
    bounded ``1 / depth_gt`` error instead of a NaN. Coordinates round half
    to even (``torch.round``, as ``jnp.round``)."""
    H, W = depth.shape
    ix = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
    iy = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
    flat = iy * W + ix
    d = depth.reshape(-1)[flat]
    a = alpha.reshape(-1)[flat]
    err = torch.abs(a / (d + eps) - 1.0 / torch.clamp(depth_gt, min=eps))
    m = mask.to(depth.dtype)
    return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)


def apply_exposure(image: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Per-view affine colour correction: (H, W, 3) image, (3, 4) affine
    [A | b] -> image @ A^T + b, for auto-exposure and white-balance drift
    (``train_colmap --exposure-opt``). Element-wise f32, as the reference's
    ``precision="highest"`` einsum: no TF32 whatever the backend's flags.
    At evaluation, render without it (or with the identity)."""
    return (image[..., 0:1] * affine[:, 0] + image[..., 1:2] * affine[:, 1]
            + image[..., 2:3] * affine[:, 2] + affine[:, 3])


def identity_exposure(n_views: int, *, device: torch.device | str) -> torch.Tensor:
    """(V, 3, 4) identity affines [I | 0] for ``apply_exposure``."""
    eye = torch.cat([torch.eye(3, device=device), torch.zeros((3, 1), device=device)], dim=1)
    return eye.expand(n_views, 3, 4).contiguous()
