"""Real spherical-harmonics colour evaluation, degrees 0-3 (PyTorch).

Counterpart of ``mojosplat_tpu.ops.sh``: coefficients ``(N, (degree+1)^2,
C)`` band-major, the standard 3DGS / gsplat real-SH basis evaluated as one
``(N, K)`` basis matrix and contracted once, and the +0.5 offset with a
clamp at 0 in ``sh_to_color``: ``torch.maximum``, which, like the
reference's ``jnp.maximum``, gives a colour exactly at 0 half the gradient
(``torch.clamp`` would give it all; an SfM point with a black channel
starts exactly there).
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

MAX_SH_DEGREE = 3


def num_sh_bases(degree: int) -> int:
    """(degree+1)^2 coefficients per channel."""
    return (degree + 1) ** 2


def _safe_normalize(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize (N, 3) directions; ``rsqrt(n2 + 1e-24)`` keeps a zero
    direction (dead slots at the camera origin) finite under autograd."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(n2 + 1e-24)


def eval_sh(sh_coeffs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Evaluate SH (N, K, C) at directions (N, 3). Returns (N, C) band sums."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree must be in [0, {MAX_SH_DEGREE}], got {degree}")
    needed = num_sh_bases(degree)
    if sh_coeffs.shape[-2] < needed:
        raise ValueError(
            f"degree {degree} needs {needed} SH bases, got {sh_coeffs.shape[-2]}"
        )

    d = _safe_normalize(dirs)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]

    basis = [torch.full_like(x, _C0)]
    if degree >= 1:
        basis += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        basis += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    B = torch.stack(basis, dim=-1)  # (N, needed)
    return torch.einsum("nk,nkc->nc", B, sh_coeffs[..., : len(basis), :])


def rgb_to_sh0(rgb):
    """Band-0 coefficients whose degree-0 colour is ``rgb``."""
    return (torch.as_tensor(rgb) - 0.5) / _C0


def sh_to_color(
    sh_coeffs: torch.Tensor,  # (N, K, C)
    means3d: torch.Tensor,  # (N, 3)
    cam_position: torch.Tensor,  # (3,)
    degree: int,
) -> torch.Tensor:
    """View-dependent RGB: SH at (mean - cam) directions, +0.5, clamped at 0."""
    dirs = means3d - cam_position[None, :]
    color = eval_sh(sh_coeffs, dirs, degree) + 0.5
    return torch.maximum(color, color.new_zeros(()))


def mask_sh_bands(features: torch.Tensor, active_degree: int) -> torch.Tensor:
    """Zero SH bands above ``active_degree``; shapes stay the same."""
    K = features.shape[-2]
    keep = num_sh_bases(active_degree)
    idx = torch.arange(K, device=features.device)
    return torch.where((idx < keep)[:, None], features, torch.zeros_like(features))
