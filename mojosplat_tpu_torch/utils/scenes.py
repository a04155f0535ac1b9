"""The evaluation view of the repository's trained scene.

Port of ``scene_camera`` in ``bench.py`` (which imports jax): the ring
convention of the synthetic capture (orbit radius 3.9, target [0, 0.4, 0],
fx = 0.72 W) at an angle none of the training views use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import Camera

TRAINED_SCENE = "assets/trained_scene_1m.npz"


def scene_camera(H: int, W: int, *, device: torch.device | str) -> Camera:
    ang = 0.618
    eye = np.array([3.9 * np.sin(ang), -0.75, 3.9 * np.cos(ang)])
    up = np.array([0.0, 1.0, 0.0])
    forward = np.array([0.0, 0.4, 0.0]) - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    R = np.stack([right, down, forward]).astype(np.float32)
    T = (-R @ eye).astype(np.float32)
    return Camera.create(
        R=R, T=T, H=H, W=W, fx=0.72 * W, fy=0.72 * W, cx=W / 2, cy=H / 2,
        device=device,
    )
