"""Record the kernel route against the plain route, for both families.

Port of ``scripts/record_parity.py``. At 100,000 gaussians (``train.
init_gaussians``, SH degree 2, position scale 2, from a CPU generator
seeded 0) at 800x600 it renders and differentiates three records on the
card, each the ``"cuda"`` route (the hand-written kernels) against the
``"torch"`` route (plain PyTorch):

  - ``3dgs``: ``render_gaussians`` with span 8 and a tile capacity of 512;
  - ``2dgs``: ``render_surfels`` on the first two log-scales;
  - ``3dgs_ts32_tight``: 32-pixel tiles, span 4, tight culling.

Each holds the forward image's largest difference, its scale, the 99.9th
percentile of the difference, the count of values off by more than 1e-5
(alpha-threshold flips show there), and each parameter's largest gradient
difference relative to its largest gradient. The reference also records a
bf16 gradient route; the port has none (``RenderConfig.grad_route_bf16``
has no effect), and the record says so in ``grad_bf16_route``.

    python -m mojosplat_tpu_torch.examples.record_parity PARITY.json [3dgs|2dgs|3dgs_ts32_tight]

Each record is written as soon as it is measured. A file recorded at the
same git revision is resumed (its records are kept and not measured
again); one recorded at another revision is discarded. Runs on the card
only (``--device cuda``). This is a tool for users: it writes no benchmark
file, and nothing reads its output as a metric.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from pathlib import Path

import torch

from mojosplat_tpu_torch import Camera, RenderConfig, render_gaussians, render_surfels
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.examples.train_colmap import resolve_device

H, W, N = 600, 800, 100_000
KW = dict(tile_capacity=512, chunk_size=64, tile_batch=512, max_tile_span=8)
# 32-pixel tiles with tight culling: other kernel shapes and the mask-decode
# slot path.
KW32 = dict(tile_capacity=512, chunk_size=64, tile_batch=512, max_tile_span=4, tile_size=32,
            tight_cull=True, isect_padding_multiplier=4)
BACKGROUND = (0.2, 0.1, 0.3)
GRAD_BF16_ROUTE = ("none: the port has no bf16 gradient route (RenderConfig.grad_route_bf16 "
                   "has no effect), so grad_max_rel_exact is the only gradient record")
FAMILIES = ("3dgs", "2dgs", "3dgs_ts32_tight")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="PARITY.json", help="the record's JSON path")
    ap.add_argument("only", nargs="?", default=None, choices=FAMILIES,
                    help="record this family only")
    ap.add_argument("--device", default="cuda", help="torch device (a CUDA device)")
    return ap


def family(render, params: dict, sh_degree: int, *, height: int = H, width: int = W,
           kw: dict = KW) -> dict:
    """One record: ``render`` on the ``"cuda"`` route against the
    ``"torch"`` route, forward and every parameter's gradient of the mean
    squared image, through an identity camera with fx = fy = width / 2."""
    dev = params["means3d"].device
    cam = Camera.create(R=torch.eye(3), T=torch.zeros(3), H=height, W=width, fx=0.5 * width,
                        fy=0.5 * width, cx=width / 2, cy=height / 2, device=dev)
    def fwd(p, impl):
        return render(p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"],
                      cam, sh_degree=sh_degree, background_color=BACKGROUND, config=RenderConfig(**kw, raster_impl=impl))

    with torch.no_grad():
        ix = fwd(params, "torch")
        ip = fwd(params, "cuda")
        adiff = torch.abs(ix - ip)
        # A slot whose alpha lands within f32 noise of the threshold (1/255)
        # is kept by one route and dropped by the other: an isolated pixel
        # off by ~alpha * colour * T. A small count above 1e-5 beside a much
        # smaller p99.9 says the largest differences are such flips.
        rec = {
            "fwd_max_abs_diff": float(adiff.max()),
            "fwd_image_scale": float(torch.abs(ix).max()),
            "fwd_p999_abs_diff": float(torch.quantile(adiff.flatten(), 0.999)),
            "fwd_pixels_above_1e5": int((adiff > 1e-5).sum()),
        }
    del ix, ip, adiff

    def grads(impl):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in sorted(params.items())}
        loss = torch.mean(fwd(p, impl) ** 2)
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    gx = grads("torch")
    gp = grads("cuda")
    rec["grad_max_rel_exact"] = {
        k: float(torch.abs(gp[k] - gx[k]).max() / torch.clamp(torch.abs(gx[k]).max(), min=1e-30))
        for k in gx}
    rec["grad_bf16_route"] = GRAD_BF16_ROUTE
    return rec


def git_rev() -> str:
    """HEAD of the checkout holding this file, or "unknown"."""
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                              check=True, cwd=Path(__file__).resolve().parents[2],
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def load_record(path: str, rev: str) -> dict:
    """The record at ``path`` if it was taken at ``rev``, else {}: a record
    from another revision could measure an older kernel."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        rec = json.load(f)
    if rec.get("git_rev") != rev:
        print(f"discarding stale results in {path} (recorded at {rec.get('git_rev')}, "
              f"HEAD is {rev})", flush=True)
        return {}
    return rec


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi unavailable: power limit unknown)"


def main(argv=None) -> dict:
    """Measure the families not yet recorded at this revision; returns the
    record as written."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, "cuda")
    rev = git_rev()
    rec = load_record(args.out, rev)
    rec.update({
        "git_rev": rev,
        "workload": f"{N} gaussians @ {W}x{H}, SH2, span 8, cap 512",
        "device": device_line(),
        "note": "routes: 'cuda' (the hand-written kernels, f32 blends) against 'torch' "
                "(plain PyTorch)",
    })
    raw = mtrain.init_gaussians(N, sh_degree=2, position_scale=2.0,
                                generator=torch.Generator().manual_seed(0), device="cpu")
    params = mtrain.activate({k: v.to(dev) for k, v in raw.items()})

    def flush():
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print("wrote", args.out, flush=True)

    size = dict(height=H, width=W)
    runs = {
        "3dgs": lambda: family(render_gaussians, params, 2, **size),
        "2dgs": lambda: family(render_surfels, dict(params, scales=params["scales"][:, :2]), 2,
                               **size),
        "3dgs_ts32_tight": lambda: family(render_gaussians, params, 2, kw=KW32, **size),
    }
    for name in FAMILIES:
        if args.only in (None, name) and name not in rec:
            rec[name] = runs[name]()
            print(json.dumps(rec[name], indent=1), flush=True)
            flush()
    return rec


if __name__ == "__main__":
    main()
