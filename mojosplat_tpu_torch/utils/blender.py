"""NeRF-synthetic (Blender) dataset loading: the transforms.json format.

Port of ``mojosplat_tpu.utils.blender`` (numpy, frames read with PIL). A JSON file with a
shared ``camera_angle_x`` (or ``fl_x``/``fl_y``) and per-frame
``file_path`` + ``transform_matrix`` (camera-to-world, OpenGL convention:
+X right, +Y up, -Z forward), converted to the port's world-to-camera
convention (+X right, +Y down, +Z forward), with the RGBA renders
composited onto a constant background.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

# OpenGL camera-to-world -> world-to-camera: flip Y and Z of the camera
# frame (diag(1, -1, -1)), then invert the rigid transform.
_FLIP_YZ = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


@dataclass
class BlenderScene:
    """A parsed transforms.json split, ready for training."""

    names: list[str]  # frame file paths (resolved)
    R: np.ndarray  # (V, 3, 3) world-to-camera rotations
    T: np.ndarray  # (V, 3) world-to-camera translations
    images: np.ndarray | None  # (V, H, W, 3) float32 in [0, 1], or None
    H: int
    W: int
    fx: float
    fy: float

    def camera_for(self, i: int, *, device: torch.device | str):
        """The port's render Camera, on ``device``, for frame ``i``."""
        from ..camera import Camera

        return Camera.create(
            R=self.R[i], T=self.T[i], H=self.H, W=self.W,
            fx=self.fx, fy=self.fy, cx=self.W / 2.0, cy=self.H / 2.0, device=device,
        )


def _c2w_to_wc(c2w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """OpenGL camera-to-world 4x4 -> world-to-camera (R, T)."""
    Rc2w = np.asarray(c2w[:3, :3], np.float32) @ _FLIP_YZ
    t = np.asarray(c2w[:3, 3], np.float32)
    R = Rc2w.T
    T = -R @ t
    return R, T


def load_blender_scene(
    path: str,
    split: str = "train",
    background=(1.0, 1.0, 1.0),
    downscale: int = 1,
    load_images: bool = True,
) -> BlenderScene:
    """Load a NeRF-synthetic scene split.

    ``path``: the scene directory (holding transforms_{split}.json) or a
    transforms .json file. RGBA frames are composited onto ``background``
    (white by the NeRF-synthetic convention). Frames are read with PIL.
    """
    if os.path.isdir(path):
        json_path = os.path.join(path, f"transforms_{split}.json")
        if not os.path.exists(json_path):
            json_path = os.path.join(path, "transforms.json")
        root = path
    else:
        json_path = path
        root = os.path.dirname(path)
    with open(json_path) as f:
        meta = json.load(f)

    names, Rs, Ts, imgs = [], [], [], []
    H = W = None
    for frame in meta["frames"]:
        full = os.path.join(root, frame["file_path"])
        if not os.path.splitext(full)[1]:
            full += ".png"
        R, T = _c2w_to_wc(np.asarray(frame["transform_matrix"], np.float32))
        if load_images:
            if not os.path.exists(full):
                continue
            from PIL import Image

            im = Image.open(full)
            if downscale > 1:
                im = im.resize((im.width // downscale, im.height // downscale),
                               Image.LANCZOS)
            arr = np.asarray(im.convert("RGBA"), np.float32) / 255.0
            a = arr[..., 3:4]
            rgb = arr[..., :3] * a + np.asarray(background, np.float32) * (1.0 - a)
            imgs.append(rgb.astype(np.float32))
            H, W = rgb.shape[:2]
        names.append(full)
        Rs.append(R)
        Ts.append(T)

    if H is None:
        # No images loaded or found: the declared or default size.
        W = int(meta.get("w", 800)) // downscale
        H = int(meta.get("h", 800)) // downscale

    if "fl_x" in meta:
        fx = float(meta["fl_x"]) / downscale
        fy = float(meta.get("fl_y", meta["fl_x"])) / downscale
    else:
        fx = fy = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))

    return BlenderScene(
        names=names,
        R=np.stack(Rs) if Rs else np.zeros((0, 3, 3), np.float32),
        T=np.stack(Ts) if Ts else np.zeros((0, 3), np.float32),
        images=np.stack(imgs).astype(np.float32) if load_images and imgs else None,
        H=int(H), W=int(W), fx=float(fx), fy=float(fy),
    )
