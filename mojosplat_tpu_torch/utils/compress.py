"""Loader for the compressed 3DGS scene format (numpy only).

Port of ``load_compressed_scene`` from ``mojosplat_tpu.utils.compress``
(the writer stays in the reference package): 16-bit means, 8-bit scales,
quats, opacities and SH DC band with per-channel min/max ranges in a JSON
header, and the SH rest bands as a float16 codebook with uint16 indices or
as 8-bit codes.
"""

from __future__ import annotations

import json

import numpy as np

_FORMAT_VERSION = 1


def _dequantize(q: np.ndarray, lo: np.ndarray, hi: np.ndarray, bits: int):
    span = np.maximum(hi - lo, 1e-12)
    return (q.astype(np.float32) / ((1 << bits) - 1)) * span + lo


def load_compressed_scene(path: str) -> dict:
    """The scene's raw parameter dict, float32 throughout: means3d (N, 3),
    scales (N, 3) log, quats (N, 4) wxyz renormalized, opacities_raw (N,)
    logits, features (N, K, 3) SH (or (N, 3) for an RGB scene)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported compressed-scene version {meta['version']}")
        n, K = meta["n"], meta["sh_k"]

        def f32(k):
            return np.asarray(meta[k], np.float32)

        means = _dequantize(z["means"], f32("means_lo"), f32("means_hi"), 16)
        scales = _dequantize(z["scales"], f32("scales_lo"), f32("scales_hi"), 8)
        quats = _dequantize(z["quats"], f32("quats_lo"), f32("quats_hi"), 8)
        quats /= np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
        opac = _dequantize(z["opacities"][:, None], f32("opac_lo"), f32("opac_hi"), 8)[:, 0]
        # Back to logits; clip so fully-transparent codes stay finite.
        opac = np.clip(opac, 1.0 / 512, 1.0 - 1.0 / 512)
        opac_raw = np.log(opac / (1.0 - opac))
        feats = np.zeros((n, K, 3), np.float32)
        feats[:, 0, :] = _dequantize(z["f_dc"], f32("dc_lo"), f32("dc_hi"), 8)
        if K > 1:
            if meta["sh_rest"] == "codebook":
                rest = z["f_rest_codebook"].astype(np.float32)[
                    z["f_rest_idx"].astype(np.int64)
                ]
            elif meta["sh_rest"] == "quant8":
                rest = _dequantize(z["f_rest"], f32("rest_lo"), f32("rest_hi"), 8)
            else:
                raise ValueError(f"unknown sh_rest mode {meta['sh_rest']!r}")
            feats[:, 1:, :] = rest.reshape(n, K - 1, 3)
    if meta.get("feats_2d"):
        feats = feats[:, 0, :]
    return dict(
        means3d=means.astype(np.float32),
        scales=scales.astype(np.float32),
        quats=quats.astype(np.float32),
        opacities_raw=opac_raw.astype(np.float32),
        features=feats,
    )
