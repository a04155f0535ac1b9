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

from .camera import Camera
from .config import DEFAULT_CONFIG, RenderConfig
from .ops.sh import num_sh_bases
from .render import render_gaussians


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


def activate(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Raw (trainable) params -> render params (sigmoid on opacities)."""
    out = dict(params)
    out["opacities"] = torch.sigmoid(out.pop("opacities_raw"))
    return out


def l2_image_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((rendered - target) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB for [0, 1] images (eps-guarded so a
    perfect fit reports ~120 dB instead of inf)."""
    return -10.0 * torch.log10(torch.mean((a - b) ** 2) + 1e-12)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    g = g / torch.sum(g)
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM between two (..., H, W, C) images in [0, 1]: the 11x11
    Gaussian-window SSIM of the 3DGS training recipe, as depthwise
    convolutions with zero padding ("SAME").

    The blurs run in full f32: cuDNN would run them in TF32 by default, and
    the variance estimate blur(x^2) - mx^2 then loses enough digits to push
    SSIM past 1 on flat regions (the reference met this on the TPU).
    """
    c1, c2 = 0.01**2, 0.03**2
    w = _gaussian_window(window_size, 1.5, a.device)[None, None]  # (1, 1, k, k)
    H, W, C = a.shape[-3:]
    x = a.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)
    y = b.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)

    def blur(img):
        return torch.nn.functional.conv2d(img, w, padding=window_size // 2)

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

    Where rendered == target exactly, ``torch.abs`` takes the subgradient 0
    and the reference's ``jnp.abs`` takes 1; elsewhere the gradients agree.
    """
    l1 = torch.mean(torch.abs(rendered - target))
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
