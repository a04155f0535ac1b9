"""Compressed 3DGS scene format: quantization + SH codebook in one .npz.

Port of ``mojosplat_tpu.utils.compress`` (numpy only), writing and reading
the same files:

  - gaussians sorted by the Morton code of their quantized positions
    (``morton_order``, also the candidate order of the SfM KNN in
    ``utils/colmap.py``);
  - 16-bit means; 8-bit scales (log), quats (sign-canonicalized, w >= 0),
    opacities (in sigmoid space) and SH DC band, each with per-channel
    min/max ranges in a JSON header;
  - the SH rest bands as a K-means codebook (float16 centres, uint16
    indices) fitted on a subsample, or as 8-bit codes;

all in ``np.savez_compressed``. Lossy: ~35+ dB against the uncompressed
render.
"""

from __future__ import annotations

import json
import os

import numpy as np

_FORMAT_VERSION = 1


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are two zero bits between each
    (the uint64 Morton interleave building block)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_order(means: np.ndarray) -> np.ndarray:
    """Sort permutation by 21-bit-per-axis Morton code of the positions."""
    lo = means.min(axis=0)
    extent = np.maximum(means.max(axis=0) - lo, 1e-12)
    q = ((means - lo) / extent * ((1 << 21) - 1)).astype(np.uint64)
    code = (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << np.uint64(1))
        | (_part1by2(q[:, 2]) << np.uint64(2))
    )
    return np.argsort(code, kind="stable")


def _quantize(a: np.ndarray, bits: int):
    """Per-channel (last axis) min/max quantization -> (codes, lo, hi)."""
    lo = a.min(axis=0)
    hi = a.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    levels = (1 << bits) - 1
    q = np.round((a - lo) / span * levels)
    dtype = np.uint8 if bits <= 8 else np.uint16
    return q.astype(dtype), lo.astype(np.float32), hi.astype(np.float32)


def _kmeans_fit(x: np.ndarray, k: int, iters: int, rng: np.random.Generator):
    """Lite Lloyd's K-means (float32 BLAS distance steps). Fits on ``x``
    (already subsampled by the caller); returns (k, D) centers."""
    n = x.shape[0]
    k = min(k, n)
    centers = x[rng.choice(n, size=k, replace=False)].copy()
    for _ in range(iters):
        idx = _kmeans_assign(x, centers)
        # Mean per cluster; empty clusters keep their previous center.
        sums = np.zeros_like(centers)
        np.add.at(sums, idx, x)
        counts = np.bincount(idx, minlength=k).astype(np.float32)
        nonempty = counts > 0
        centers[nonempty] = sums[nonempty] / counts[nonempty, None]
    return centers


def _kmeans_assign(x: np.ndarray, centers: np.ndarray,
                   chunk: int = 65536) -> np.ndarray:
    """Nearest-center index per row, chunked so the (chunk, k) distance
    block stays cache/RAM friendly at millions of rows."""
    c_sq = np.einsum("kd,kd->k", centers, centers)
    out = np.empty(x.shape[0], np.int64)
    for s in range(0, x.shape[0], chunk):
        xs = x[s : s + chunk]
        # argmin over ||x||^2 - 2 x.c + ||c||^2; the x^2 term is constant
        # per row and dropped.
        d = c_sq[None, :] - 2.0 * (xs @ centers.T)
        out[s : s + chunk] = np.argmin(d, axis=1)
    return out


def compress_scene(
    path: str,
    params: dict,
    sh_codebook_size: int | None = 4096,
    kmeans_iters: int = 8,
    kmeans_sample: int = 131072,
    seed: int = 0,
) -> dict:
    """Write a compressed scene. ``params`` uses the PLY-io convention
    (utils/ply.py): means3d (N,3), scales (N,3 log), quats (N,4 wxyz),
    opacities_raw (N,) logits, features (N, K, 3) SH.

    Returns a stats dict: {"bytes", "raw_bytes", "ratio", "n", "sh_k"}.
    """
    if sh_codebook_size is not None and not 1 <= sh_codebook_size <= 65536:
        raise ValueError(
            f"sh_codebook_size must be in [1, 65536] (uint16 indices), "
            f"got {sh_codebook_size}"
        )
    rng = np.random.default_rng(seed)
    means = np.asarray(params["means3d"], np.float32)
    scales = np.asarray(params["scales"], np.float32)
    quats = np.asarray(params["quats"], np.float32)
    opac_raw = np.asarray(params["opacities_raw"], np.float32)
    feats = np.asarray(params["features"], np.float32)
    feats_2d = feats.ndim == 2  # plain RGB features round-trip as (N, 3)
    if feats_2d:
        feats = feats[:, None, :]
    n, K, _ = feats.shape

    order = morton_order(means)
    means, scales, quats, opac_raw, feats = (
        means[order], scales[order], quats[order], opac_raw[order],
        feats[order],
    )

    # Quats: unit-normalize then canonicalize sign (w >= 0) so the 8-bit
    # grid isn't spent on the double cover.
    qn = quats / np.maximum(
        np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12
    )
    qn = np.where(qn[:, :1] < 0, -qn, qn)

    opac = 1.0 / (1.0 + np.exp(-opac_raw))

    q_means, means_lo, means_hi = _quantize(means, 16)
    q_scales, scales_lo, scales_hi = _quantize(scales, 8)
    q_quats, quats_lo, quats_hi = _quantize(qn, 8)
    q_opac, opac_lo, opac_hi = _quantize(opac[:, None], 8)
    q_dc, dc_lo, dc_hi = _quantize(feats[:, 0, :], 8)

    arrays = dict(
        means=q_means, scales=q_scales, quats=q_quats,
        opacities=q_opac[:, 0], f_dc=q_dc,
    )
    meta = dict(
        version=_FORMAT_VERSION, n=n, sh_k=K, feats_2d=bool(feats_2d),
        means_lo=means_lo.tolist(), means_hi=means_hi.tolist(),
        scales_lo=scales_lo.tolist(), scales_hi=scales_hi.tolist(),
        quats_lo=quats_lo.tolist(), quats_hi=quats_hi.tolist(),
        opac_lo=opac_lo.tolist(), opac_hi=opac_hi.tolist(),
        dc_lo=dc_lo.tolist(), dc_hi=dc_hi.tolist(),
        sh_rest="none",
    )

    if K > 1:
        rest = feats[:, 1:, :].reshape(n, -1)  # (N, (K-1)*3)
        if sh_codebook_size is not None:
            sample = rest
            if n > kmeans_sample:
                sample = rest[rng.choice(n, kmeans_sample, replace=False)]
            centers = _kmeans_fit(
                sample, sh_codebook_size, kmeans_iters, rng
            )
            idx = _kmeans_assign(rest, centers)
            arrays["f_rest_idx"] = idx.astype(np.uint16)
            arrays["f_rest_codebook"] = centers.astype(np.float16)
            meta["sh_rest"] = "codebook"
        else:
            q_rest, rest_lo, rest_hi = _quantize(rest, 8)
            arrays["f_rest"] = q_rest
            meta["rest_lo"] = rest_lo.tolist()
            meta["rest_hi"] = rest_hi.tolist()
            meta["sh_rest"] = "quant8"

    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    ).copy()
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)

    nbytes = os.path.getsize(path)
    raw = 4 * (means.size + scales.size + quats.size + opac_raw.size
               + feats.size)
    return dict(bytes=nbytes, raw_bytes=raw, ratio=raw / max(nbytes, 1),
                n=n, sh_k=K)


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
