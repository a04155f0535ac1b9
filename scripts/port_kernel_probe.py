#!/usr/bin/env python3
"""Which op chain binds the blend kernel B1? The stripped-variant probe on
one NVIDIA GPU.

Run from the repository root:

    python3 scripts/port_kernel_probe.py [VARIANTS]

VARIANTS is a comma-separated list of ``raster_probe.VARIANTS`` (full,
noexp, exp2, nomask, noscan, blend, memonly, blend1, blend3) and ``parity``;
the default is every variant and ``parity``. Each variant replays B1 with
one operation chain stripped, or with its blend product at a bf16 matrix
unit's precisions (``mojosplat_tpu_torch/ops/raster_probe.py``); only
``full`` gives the right image. The configuration is the reference probe's
(``scripts/dev_kernel_probe.py``): 1M gaussians from ``init_gaussians`` with
a seeded generator, position scale 2.0, SH degree 3, 1920x1080, fx = fy =
0.5 W, tile_size 16, max_tile_span 8, tile_capacity 512, and chunks of 256
slots. It prints the card's name and power limit, then

  - with ``parity``: max|blend1 - full|, max|blend3 - full|, max|exp2 -
    full| and the scale max|full|;
  - each variant's time: the median of 20 runs between CUDA events after 3
    warm-ups.

It needs no network and no jax.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
H, W, N_GAUSSIANS, SH_DEGREE, SEED = 1080, 1920, 1_000_000, 3, 0
PROBE_BUDGETS = dict(tile_size=16, max_tile_span=8, tile_capacity=512, chunk_size=64,
                     tile_batch=512)


def event_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` between two CUDA events and a
    synchronize, over ``runs`` runs after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_inputs(device, seed: int = SEED):
    """B1's inputs at the probe's configuration: (pdata, counts, ts, tw,
    config), the packed slot table and per-tile counts of the "cuda"
    route's render of a seeded random cloud."""
    from mojosplat_tpu_torch import Camera, RenderConfig
    from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles, num_tiles
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.raster_cuda import gather_tile_data
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.slice_cuda import segment_slice_gather
    from mojosplat_tpu_torch.train import activate, init_gaussians

    cfg = RenderConfig(raster_impl="cuda", **PROBE_BUDGETS)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = activate(init_gaussians(N_GAUSSIANS, sh_degree=SH_DEGREE, position_scale=2.0,
                                     generator=gen, device=device))
    camera = Camera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=0.5 * W, fy=0.5 * W,
                           cx=W / 2, cy=H / 2, device=device)
    with torch.no_grad():
        colors = sh_to_color(params["features"], params["means3d"], camera.position, SH_DEGREE)
        proj = project_gaussians(params["means3d"], params["scales"], params["quats"],
                                 params["opacities"], camera, cfg)
        bins = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, H, W, cfg)
        ranges = bins.tile_ranges.reshape(-1, 2)
        counts = torch.clamp(ranges[:, 1] - ranges[:, 0], 0, cfg.tile_capacity).to(torch.int32)
        slot_gids = segment_slice_gather(bins.gaussian_ids, ranges[:, 0].contiguous(),
                                         cfg.tile_capacity)
        pdata = gather_tile_data(proj.means2d, proj.conics, colors, params["opacities"],
                                 slot_gids, counts)
    _, tw = num_tiles(H, W, cfg.tile_size)
    return pdata, counts, cfg.tile_size, tw, cfg


def parity(outs: dict) -> dict:
    """How far the fast paths move the image: max |variant - full| of
    blend1, blend3 and exp2, and the scale max |full|."""
    full = outs["full"]
    out = {f"max|{v}-full|": float((outs[v] - full).abs().max())
           for v in ("blend1", "blend3", "exp2")}
    out["scale"] = float(full.abs().max())
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("port_kernel_probe: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from mojosplat_tpu_torch.ops.raster_probe import PROBE_CHUNK, VARIANTS, raster_variant

    names = argv[0].split(",") if argv else list(VARIANTS) + ["parity"]
    unknown = set(names) - set(VARIANTS) - {"parity"}
    if unknown:
        raise SystemExit(f"port_kernel_probe: unknown variants {sorted(unknown)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    pdata, counts, ts, tw, cfg = probe_inputs(dev)
    print(f"pdata {tuple(pdata.shape)}, {int(counts.sum())} slots in {counts.shape[0]} tiles, "
          f"chunk {PROBE_CHUNK}", flush=True)

    def run(v):
        return raster_variant(v, pdata, counts, ts, tw, cfg, PROBE_CHUNK)

    if "parity" in names:
        line = parity({v: run(v) for v in ("full", "blend1", "blend3", "exp2")})
        print(" ".join(f"{k}={v:.3e}" for k, v in line.items()), flush=True)
    for v in (n for n in names if n != "parity"):
        print(f"{v:10s} {event_ms(lambda v=v: run(v)):8.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
