"""``.splat`` scene IO, the web-viewer format (numpy only).

Port of ``mojosplat_tpu.utils.splat``. 32 bytes per gaussian:

    position  3 x f32   (world xyz)
    scale     3 x f32   (linear scales, not log)
    color     4 x u8    (RGB in [0, 255] from the SH DC term, A = opacity)
    rotation  4 x u8    (quat wxyz quantized q * 128 + 128)

sorted by descending importance (volume x opacity). Lossy by design; PLY
(``utils/ply.py``) is the lossless format.
"""

from __future__ import annotations

import numpy as np

from ..ops.sh import _C0

_RECORD = [("pos", "<f4", 3), ("scale", "<f4", 3), ("color", "u1", 4), ("rot", "u1", 4)]


def save_gaussian_splat(path: str, params: dict) -> None:
    """Write the raw parameter dict (numpy arrays) as a .splat file."""
    means = np.asarray(params["means3d"], np.float32)
    scales = np.exp(np.asarray(params["scales"], np.float32))
    quats = np.asarray(params["quats"], np.float32)
    quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    opac = 1.0 / (1.0 + np.exp(-np.asarray(params["opacities_raw"], np.float32)))
    feats = np.asarray(params["features"], np.float32)
    rgb = feats[:, 0, :] * _C0 + 0.5 if feats.ndim == 3 else feats

    order = np.argsort(-(scales.prod(axis=-1) * opac))  # volume x opacity, descending
    rec = np.zeros(means.shape[0], dtype=_RECORD)
    rec["pos"] = means[order]
    rec["scale"] = scales[order]
    rec["color"][:, :3] = np.clip(rgb[order] * 255.0, 0, 255).astype(np.uint8)
    rec["color"][:, 3] = np.clip(opac[order] * 255.0, 0, 255).astype(np.uint8)
    rec["rot"] = np.clip(quats[order] * 128.0 + 128.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def load_gaussian_splat(path: str) -> dict:
    """Read a .splat file into the raw parameter dict: (N, 3) RGB features
    (the format keeps no higher SH bands), opacity back through the logit."""
    blob = np.fromfile(path, dtype=np.uint8)
    if blob.size % 32 != 0:
        raise ValueError(f"{path}: size {blob.size} is not a multiple of 32")
    rec = blob.view(_RECORD)
    opac = np.clip(rec["color"][:, 3].astype(np.float32) / 255.0, 1e-4, 1.0 - 1e-4)
    quats = (rec["rot"].astype(np.float32) - 128.0) / 128.0
    quats /= np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    return dict(
        means3d=rec["pos"].astype(np.float32),
        scales=np.log(np.maximum(rec["scale"].astype(np.float32), 1e-12)),
        quats=quats,
        opacities_raw=np.log(opac / (1.0 - opac)),
        features=rec["color"][:, :3].astype(np.float32) / 255.0,
    )
