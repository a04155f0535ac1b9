"""A configuration's scene: the raw parameters both sides are given.

The compressed scene format (16-bit means; 8-bit log-scales, quaternions,
opacities and SH DC, each with per-channel ranges in a JSON header; the SH
rest bands as a float16 K-means codebook or 8-bit codes) is decoded here,
on the device, so that no code of the program makes the inputs it is
judged on. A 2DGS scene keeps the first two log-scales of each gaussian.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

KEYS = ("means3d", "scales", "quats", "opacities_raw", "features")


def _dequant(q: np.ndarray, lo, hi, bits: int, dev) -> torch.Tensor:
    q = torch.from_numpy(q.astype(np.int32)).to(dev).to(torch.float32)
    lo = torch.tensor(lo, dtype=torch.float32, device=dev)
    span = torch.clamp(torch.tensor(hi, dtype=torch.float32, device=dev) - lo, min=1e-12)
    return q / float((1 << bits) - 1) * span + lo


def load_scene(path: Path, family: str, dev, every: int = 1) -> dict:
    """Raw float32 parameters (opacities as logits, log-scales, wxyz
    quaternions, (N, K, 3) SH) of every ``every``-th gaussian."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta["version"] != 1 or meta["feats_2d"]:
            raise ValueError(f"{path}: not a version-1 SH scene")
        pick = slice(None, None, every)

        def arr(k):
            return z[k][pick]

        means = _dequant(arr("means"), meta["means_lo"], meta["means_hi"], 16, dev)
        scales = _dequant(arr("scales"), meta["scales_lo"], meta["scales_hi"], 8, dev)
        quats = _dequant(arr("quats"), meta["quats_lo"], meta["quats_hi"], 8, dev)
        quats = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-12)
        op = _dequant(arr("opacities")[:, None], meta["opac_lo"], meta["opac_hi"], 8, dev)[:, 0]
        op = torch.clamp(op, 1.0 / 512, 1.0 - 1.0 / 512)
        n, K = means.shape[0], meta["sh_k"]
        feats = torch.zeros((n, K, 3), dtype=torch.float32, device=dev)
        feats[:, 0, :] = _dequant(arr("f_dc"), meta["dc_lo"], meta["dc_hi"], 8, dev)
        if K > 1:
            if meta["sh_rest"] == "codebook":
                book = torch.from_numpy(z["f_rest_codebook"].astype(np.float32)).to(dev)
                rest = book[torch.from_numpy(arr("f_rest_idx").astype(np.int64)).to(dev)]
            else:
                rest = _dequant(arr("f_rest"), meta["rest_lo"], meta["rest_hi"], 8, dev)
            feats[:, 1:, :] = rest.reshape(n, K - 1, 3)
    if family == "2dgs":
        scales = scales[:, :2].contiguous()
    return dict(means3d=means, scales=scales, quats=quats,
                opacities_raw=torch.log(op / (1.0 - op)), features=feats)


def perturbed(raw: dict, sigma: dict, gen: torch.Generator) -> dict:
    """Copies of the raw parameters with N(0, sigma[key]^2) noise drawn
    from ``gen`` on their device, one draw a leaf."""
    return {k: v + torch.randn(v.shape, generator=gen, device=v.device) * sigma[k]
            for k, v in raw.items()}
