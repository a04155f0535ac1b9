"""Compress a trained 3DGS scene (PLY or .splat) into the quantized .npz
format, optionally verifying render fidelity before/after.

Port of ``examples/compress_scene.py`` on the port's ``utils.compress`` and
``utils.ply``: the files it writes are byte-equal to the reference CLI's.

    python -m mojosplat_tpu_torch.examples.compress_scene scene.ply out.npz
    python -m mojosplat_tpu_torch.examples.compress_scene scene.ply out.npz --verify
    python -m mojosplat_tpu_torch.examples.compress_scene out.npz roundtrip.ply

``--verify`` renders the scene before and after on ``--device`` through
``--impl`` (the card and the CUDA kernels by default; ``--device cpu
--impl torch`` on the CPU) and reports the PSNR between the two.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.utils.compress import compress_scene, load_compressed_scene
from mojosplat_tpu_torch.utils.ply import load_gaussian_ply, save_gaussian_ply


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="input scene (.ply / .splat / .npz)")
    ap.add_argument("dst", help="output (.npz to compress, .ply to expand)")
    ap.add_argument("--codebook", type=int, default=4096,
                    help="SH-rest K-means codebook size (0 = plain 8-bit)")
    ap.add_argument("--verify", action="store_true",
                    help="render before/after and report PSNR")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the --verify renders; the CPU only when asked for")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    return ap


def _load_any(path: str) -> dict:
    if path.endswith(".npz"):
        return load_compressed_scene(path)
    if path.endswith(".splat"):
        from mojosplat_tpu_torch.utils.splat import load_gaussian_splat

        return load_gaussian_splat(path)
    return load_gaussian_ply(path)


def verify_camera(params: dict, *, device):
    """The verification view: 2.5 x the 90th-percentile extent behind the
    centre along -z, 960x540, focal 500."""
    from mojosplat_tpu_torch import Camera, look_at

    center = np.asarray(params["means3d"]).mean(axis=0)
    extent = float(np.percentile(np.linalg.norm(params["means3d"] - center, axis=-1), 90))
    R, T = look_at(eye=center + np.array([0.0, 0.0, -2.5 * extent - 1e-3]), target=center,
                   up=[0.0, 1.0, 0.0], device=device)
    return Camera.create(R=R, T=T, H=540, W=960, fx=500.0, fy=500.0, cx=480.0, cy=270.0,
                         device=device)


def verify_psnr(params_a: dict, params_b: dict, sh_k: int, impl: str, device) -> float:
    """PSNR of ``params_b``'s render against ``params_a``'s at
    ``verify_camera(params_a)``."""
    from mojosplat_tpu_torch import RenderConfig, render_gaussians
    from mojosplat_tpu_torch import train as mtrain
    from mojosplat_tpu_torch.convert import params_from_numpy

    cam = verify_camera(params_a, device=device)
    # K = (degree+1)^2 bases -> degree.
    sh_degree = None if sh_k == 0 else int(round(sh_k**0.5)) - 1
    config = RenderConfig(raster_impl=impl)

    def render(raw):
        p = mtrain.activate(params_from_numpy(raw, device))
        with torch.no_grad():
            return render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                                    p["features"], cam, sh_degree=sh_degree, config=config)

    a, b = render(params_a), render(params_b)
    mse = float(torch.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns the compression stats (or the
    gaussian count when expanding) and, with ``--verify``, the PSNR and its
    time."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    params = _load_any(args.src)
    n = params["means3d"].shape[0]
    feats = np.asarray(params["features"])
    sh_k = feats.shape[1] if feats.ndim == 3 else 0

    if args.dst.endswith(".npz"):
        stats = compress_scene(
            args.dst, params, sh_codebook_size=None if args.codebook == 0 else args.codebook)
        print(f"{n} gaussians (SH K={sh_k}) -> {stats['bytes']/1e6:.2f} MB "
              f"({stats['ratio']:.1f}x smaller than float32)")
        if args.verify:
            t0 = time.perf_counter()
            back = load_compressed_scene(args.dst)
            stats["psnr"] = verify_psnr(params, back, sh_k, args.impl, dev)
            stats["verify_s"] = time.perf_counter() - t0
            print(f"render PSNR vs original: {stats['psnr']:.1f} dB")
        return stats
    save_gaussian_ply(args.dst, params)
    print(f"wrote {args.dst} ({n} gaussians)")
    return dict(n=n, bytes=os.path.getsize(args.dst))


if __name__ == "__main__":
    main()
