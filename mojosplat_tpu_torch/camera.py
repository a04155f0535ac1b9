"""Camera models (PyTorch).

Counterpart of ``mojosplat_tpu.camera``: world-to-camera rotation ``R``
(3, 3), translation ``T`` (3,), image size ``H, W`` as Python ints,
intrinsics ``fx, fy, cx, cy`` and ``near`` / ``far`` planes, all other
fields tensors on one device. Leading batch dimensions on the tensor fields
are allowed, as in the reference package.

``camera_model`` selects the lens map:
  - ``"pinhole"``: perspective, with OpenCV radial/tangential distortion
    ``dist = (k1, k2, p1, p2, k3)`` applied by the unscented projection
    (the EWA projection ignores it);
  - ``"fisheye"``: OpenCV equidistant, ``theta_d = theta (1 + k1 th^2 +
    k2 th^4 + k3 th^6 + k4 th^8)`` with ``dist = (k1, k2, k3, k4, unused)``;
    always projected by the unscented transform;
  - ``"ortho"``: orthographic, ``u = fx x + cx`` (``fx`` in pixels per
    world unit), exact in both projection modes.

``shutter="rolling"`` reads the rows top to bottom over one frame: ``(R,
T)`` is the mid-exposure pose and ``rs_vel = [omega (3), upsilon (3)]``
the se(3) velocity over the frame, so the pose at row time ``t in [-0.5,
0.5]`` is ``exp([t omega]x) R``, ``exp([t omega]x) T + t upsilon``.
Rolling cameras are projected by the unscented transform.

``apply_pose_delta`` perturbs the extrinsics by a learnable (6,) se(3)
delta (pose refinement), differentiably and exactly at zero.
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
    dist: torch.Tensor  # (..., 5); meaning depends on camera_model
    rs_vel: torch.Tensor  # (..., 6) [omega, upsilon]; only read by a rolling shutter
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
        ``dtype``. ``dist`` (..., 5) and ``rs_vel`` (..., 6) default to
        zeros, broadcast to the batch shape of ``fx``."""
        if camera_model not in ("pinhole", "fisheye", "ortho"):
            raise ValueError(f"Unknown camera_model: {camera_model!r}")
        if shutter not in ("global", "rolling"):
            raise ValueError(f"Unknown shutter: {shutter!r}")

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
            camera_model=camera_model,
            shutter=shutter,
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


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation: exact Rodrigues with a
    Taylor switch at theta ~ 0. sin(t)/t and (1 - cos(t))/t^2 are 0/0
    there, so the input of the unselected branch is sanitised as well
    (double where): the zero rotation's gradient stays finite."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    O = torch.zeros_like(wx)
    K = torch.stack([O, -wz, wy, wz, O, -wx, -wy, wx, O], dim=-1).reshape(
        omega.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def apply_pose_delta(camera: Camera, delta: torch.Tensor) -> Camera:
    """The camera with its world-to-camera map perturbed by a learnable
    se(3) delta: (..., 6) = [omega (3, axis-angle), upsilon (3)],
    broadcasting against the camera's batch shape. A left perturbation,
    R' = exp([omega]x) R and T' = exp([omega]x) T + upsilon: a zero delta
    returns R and T unchanged, and the gradients at zero are exact."""
    dR = _rodrigues(delta[..., 0:3])
    R = dR @ camera.R
    T = (dR @ camera.T[..., None])[..., 0] + delta[..., 3:6]
    return dataclasses.replace(camera, R=R, T=T)


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
