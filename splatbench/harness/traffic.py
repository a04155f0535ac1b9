"""The one traffic generator: every mix is a JSON file of parameters under
``splatbench/traffic/`` that this module reads.

Two kinds of mix exist:

  - ``"train"``: training steps, one view a step, over a fixed capture of
    ``views.count`` poses on a ring. The seed draws the order of the views
    (a fresh permutation every epoch) and the noise on the parameters, so
    every seed trains on the same views, in another order.
  - ``"orbit"``: a viewer's closed loop of frames: the pose advances
    ``yaw_step_deg`` of yaw a frame around the ring, from a start drawn
    from the seed among the ring's ``360 / yaw_step_deg`` poses.

Poses lie on a ring around the vertical axis through ``target``: the eye
at ``(radius sin a, eye_y, radius cos a)``, looking at ``target``, with
``fx = fy = fx_over_width * W`` and the principal point at the centre;
camera axes x right, y down, z forward.
"""

from __future__ import annotations

import math

import numpy as np


def ring_pose(ring: dict, yaw_deg: float, H: int, W: int) -> dict:
    """A pinhole pose on the ring: world-to-camera R (3x3), T (3,),
    intrinsics in pixels, the image size and the near / far planes."""
    a = math.radians(yaw_deg)
    eye = np.array([ring["radius"] * math.sin(a), ring["eye_y"], ring["radius"] * math.cos(a)])
    fwd = np.asarray(ring["target"], dtype=np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    f = ring["fx_over_width"] * W
    return dict(R=R.astype(np.float32), T=(-R @ eye).astype(np.float32), fx=f, fy=f,
                cx=W / 2, cy=H / 2, H=H, W=W, near=ring["near"], far=ring["far"],
                yaw_deg=yaw_deg)


def grid_size(mix: dict) -> int:
    """Poses on the ring's grid of ``yaw_step_deg``."""
    return int(round(360.0 / mix["yaw_step_deg"]))


def pose_yaw(mix: dict, k: int) -> float:
    return mix["ring"]["yaw0_deg"] + (k % grid_size(mix)) * mix["yaw_step_deg"]


def pose(mix: dict, k: int) -> dict:
    """Pose k of the mix's grid."""
    return ring_pose(mix["ring"], pose_yaw(mix, k), mix["height"], mix["width"])


def view_grid_ids(mix: dict) -> list[int]:
    """Grid indices of a train mix's capture views."""
    stride = mix["views"]["every"]
    return [k * stride for k in range(mix["views"]["count"])]


def all_pose_ids(mix: dict) -> list[int]:
    """Every grid pose the mix can ask for, whatever the seed."""
    return view_grid_ids(mix) if mix["kind"] == "train" else list(range(grid_size(mix)))


class TrainOrder:
    """The seed's sequence of capture views: a fresh permutation of the
    views each epoch."""

    def __init__(self, mix: dict, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n = mix["views"]["count"]
        self.buf: list[int] = []

    def next(self) -> int:
        if not self.buf:
            self.buf = [int(i) for i in self.rng.permutation(self.n)]
        return self.buf.pop(0)


def orbit_start(mix: dict, seed: int) -> int:
    """The seed's first grid pose of an orbit."""
    return int(np.random.default_rng(seed).integers(grid_size(mix)))
