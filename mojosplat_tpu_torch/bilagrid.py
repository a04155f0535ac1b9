"""Per-view bilateral-grid appearance correction.

Counterpart of ``mojosplat_tpu.bilagrid`` (the gsplat ecosystem's
``lib_bilagrid``, Wang et al. SIGGRAPH 2024): a low-resolution 3D grid
(spatial y, spatial x, guidance = luminance) of 3x4 affine colour
transforms, trilinearly interpolated per pixel. It absorbs spatially
varying photometric nuisance (vignetting, local white balance) that one
per-view affine (``train.apply_exposure``) cannot.

The interpolation is factored as the reference factors it: the two
spatial dimensions are one bilinear resize of each guidance slice to
(H, W), and the guidance dimension is a ``gd``-step loop of hat-weighted
accumulation (the hat weights sum to 1, so this is exactly trilinear). The
resize is ``jax.image.resize(..., "linear")``'s: one (H, gh) and one
(W, gw) weight matrix (``_resize_weights``: the triangle kernel at
half-pixel centres, renormalised over the samples in bounds, widened where
the image is smaller than the grid) contracted with the grid by matmuls,
so it is deterministic on the card (no atomics in the backward) and agrees
with JAX to f32 rounding at any size (``tests/test_torch_train_extras.py``).
``F.interpolate`` differs at the border without its antialias mode, and
its antialiased kernel took ~80 ms a slice at 1080p on an H100.

At evaluation, render without the correction (or with the identity) so
metrics measure the scene, not the per-view nuisance fit.
"""

from __future__ import annotations

import torch

# Rec.601 luma; the guidance signal of the bilateral grid.
_LUMA = (0.299, 0.587, 0.114)


def identity_bilateral_grid(n_views: int, shape: tuple[int, int, int] = (16, 16, 8), *,
                            device: torch.device | str) -> torch.Tensor:
    """(V, gh, gw, gd, 12) grids of identity affines [I | 0] on ``device``.

    ``shape`` = (gh, gw, gd): spatial rows, spatial columns, guidance
    bins. The 12 channels are the row-major 3x3 matrix, then the bias."""
    gh, gw, gd = shape
    ident = torch.cat([torch.eye(3, device=device).reshape(9), torch.zeros(3, device=device)])
    return ident.expand(n_views, gh, gw, gd, 12).contiguous()


def _resize_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor | None:
    """(n_out, n_in) weights of ``jax.image.resize(..., "linear")`` along
    one axis, computed with its operations in ``dtype``; None where the
    sizes are equal (the resize is the identity there)."""
    if n_in == n_out:
        return None
    inv = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=dtype, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=dtype, device=device)[:, None])
    w = torch.clamp(1.0 - x / max(inv, 1.0), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T.contiguous()


def apply_bilateral_grid(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """One view's bilateral grid (gh, gw, gd, 12) applied to an (H, W, 3)
    image. The guidance is the pixel's Rec.601 luma clipped to [0, 1].
    Differentiable in both inputs. The resize's matmuls follow torch's
    TF32 setting for matmuls (off by default; the CLIs keep it off)."""
    H, W, _ = image.shape
    gh, gw, gd, pc = grid.shape
    if pc != 12:
        raise ValueError(f"grid last dim must be 12 affine params, got {pc}")

    # The clip, |x| and the hat's max take the reference's gradients at
    # their kinks (jnp.clip and jnp.maximum split a tie's in half, jnp.abs
    # takes +1 at 0): a black pixel's luma sits exactly at 0, on a bin.
    zero = image.new_zeros(())
    luma = torch.minimum(torch.maximum(
        _LUMA[0] * image[..., 0] + _LUMA[1] * image[..., 1] + _LUMA[2] * image[..., 2],
        zero), zero + 1.0)
    pos = luma * (gd - 1)  # (H, W) in [0, gd - 1]

    wy = _resize_weights(gh, H, grid.dtype, grid.device)
    wx = _resize_weights(gw, W, grid.dtype, grid.device)
    rows = grid if wy is None else torch.einsum("hy,yxkc->hxkc", wy, grid)  # (H, gw, gd, 12)
    affine = torch.zeros((H, W, 12), dtype=image.dtype, device=image.device)
    for k in range(gd):
        # Hat weight: 1 at bin k, linear to 0 at k +- 1; sums to 1 over k.
        d = pos - k
        wk = torch.maximum(1.0 - torch.where(d < 0, -d, d), zero)
        slice_k = rows[:, :, k, :] if wx is None else torch.matmul(wx, rows[:, :, k, :])
        affine = affine + wk[..., None] * slice_k

    A = affine[..., :9].reshape(H, W, 3, 3)
    b = affine[..., 9:]
    # out_d = sum_c A[d, c] image_c, element-wise.
    return (A * image[..., None, :]).sum(-1) + b


def bilateral_grid_tv(grids: torch.Tensor) -> torch.Tensor:
    """Total-variation regulariser over the grid dims: the mean squared
    forward difference along gh, gw and gd, summed over the three axes.
    ``grids``: (V, gh, gw, gd, 12) or one (gh, gw, gd, 12)."""
    tv = 0.0
    for axis in (-4, -3, -2):
        d = torch.diff(grids, dim=axis)
        tv = tv + torch.mean(d * d)
    return tv
