"""Pinhole camera with a global shutter (PyTorch).

Counterpart of ``mojosplat_tpu.camera``: world-to-camera rotation ``R``
(3, 3), translation ``T`` (3,), image size ``H, W`` as Python ints, pinhole
intrinsics ``fx, fy, cx, cy`` and ``near`` / ``far`` planes, all other
fields tensors on one device. Leading batch dimensions on the tensor fields
are allowed, as in the reference package.

Only the pinhole lens with a global shutter is ported; ``create`` raises
``NotImplementedError`` for fisheye, ortho and rolling-shutter cameras.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    R: torch.Tensor  # (..., 3, 3) world-to-camera rotation
    T: torch.Tensor  # (..., 3)    world-to-camera translation
    H: int
    W: int
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    dist: torch.Tensor  # (..., 5) OpenCV coefficients; EWA ignores them
    rs_vel: torch.Tensor  # (..., 6) only read by a rolling shutter
    camera_model: str = "pinhole"
    shutter: str = "global"

    @staticmethod
    def create(
        R,
        T,
        H: int,
        W: int,
        fx,
        fy,
        cx,
        cy,
        *,
        device: torch.device | str,
        near=0.1,
        far=100.0,
        dist=None,
        dtype: torch.dtype = torch.float32,
        camera_model: str = "pinhole",
        rs_vel=None,
        shutter: str = "global",
    ) -> "Camera":
        """Build a camera on ``device``, coercing scalars/arrays to
        ``dtype``."""
        if camera_model not in ("pinhole", "fisheye", "ortho"):
            raise ValueError(f"Unknown camera_model: {camera_model!r}")
        if shutter not in ("global", "rolling"):
            raise ValueError(f"Unknown shutter: {shutter!r}")
        if camera_model != "pinhole":
            raise NotImplementedError(
                f"camera_model {camera_model!r} is not ported yet (pinhole only)"
            )
        if shutter != "global":
            raise NotImplementedError("rolling shutter is not ported yet")

        def as_t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        fx_t = as_t(fx)
        if dist is None:
            dist_t = torch.zeros(fx_t.shape + (5,), dtype=dtype, device=device)
        else:
            dist_t = torch.broadcast_to(as_t(dist), fx_t.shape + (5,))
        if rs_vel is None:
            rs_t = torch.zeros(fx_t.shape + (6,), dtype=dtype, device=device)
        else:
            rs_t = torch.broadcast_to(as_t(rs_vel), fx_t.shape + (6,))
        return Camera(
            R=as_t(R),
            T=as_t(T),
            H=int(H),
            W=int(W),
            fx=fx_t,
            fy=as_t(fy),
            cx=as_t(cx),
            cy=as_t(cy),
            near=as_t(near),
            far=as_t(far),
            dist=dist_t,
            rs_vel=rs_t,
        )

    @property
    def view_matrix(self) -> torch.Tensor:
        """(..., 4, 4) world-to-camera matrix [R | T; 0 0 0 1]."""
        batch = self.R.shape[:-2]
        vm = torch.eye(4, dtype=self.R.dtype, device=self.R.device)
        vm = vm.expand(batch + (4, 4)).clone()
        vm[..., :3, :3] = self.R
        vm[..., :3, 3] = self.T
        return vm

    @property
    def K(self) -> torch.Tensor:
        """(..., 3, 3) intrinsics matrix."""
        fx, fy, cx, cy = torch.broadcast_tensors(self.fx, self.fy, self.cx, self.cy)
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack(
            [
                torch.stack([fx, z, cx], dim=-1),
                torch.stack([z, fy, cy], dim=-1),
                torch.stack([z, z, o], dim=-1),
            ],
            dim=-2,
        )

    @property
    def position(self) -> torch.Tensor:
        """(..., 3) camera center in world coordinates: -R^T @ T."""
        return -torch.einsum("...ji,...j->...i", self.R, self.T)


def look_at(eye, target, up, *, device: torch.device | str):
    """World-to-camera (R, T) for a camera at ``eye`` looking at ``target``
    (+X right, +Y down, +Z forward into the scene)."""
    eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    up = torch.as_tensor(up, dtype=torch.float32, device=device)

    def _normalize(v):
        return v / torch.clamp(torch.linalg.norm(v), min=1e-12)

    forward = _normalize(target - eye)
    right = _normalize(torch.linalg.cross(forward, up))
    down = torch.linalg.cross(right, forward)
    R = torch.stack([right, down, forward], dim=0)
    T = -R @ eye
    return R, T
