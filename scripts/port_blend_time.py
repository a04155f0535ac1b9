#!/usr/bin/env python3
"""Time the 3DGS blend kernels B1 and B2 at the trained scene's shapes, on
one NVIDIA GPU.

Run from the root of a checkout (its kernels are built there):

    python3 scripts/port_blend_time.py

The inputs are chip_smoke.py phase 4's: the trained 1M-gaussian scene at
1920x1080 with preset 6's budgets (tight_cull), binned on the "torch"
route; B2 gets a seeded output cotangent. Prints B1's and B2's ptxas lines
(registers, shared memory, spills) and, as its last line, one JSON object:
B1's time without and with its residual and B2's time (median of 20
CUDA-event runs after 3 warm-ups, chip_smoke.cuda_ms), the card's name
and power limit, and the sum of |d pdata| (to tell two designs' outputs
apart). To compare two designs of a kernel, run the script in each tree
in one call.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("port_blend_time: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mojosplat_tpu_torch import RenderConfig, _kernels
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops import binning
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.raster_cuda import (
        gather_tile_data, raster_tiles, raster_tiles_bwd, raster_tiles_fwd)
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.slice_cuda import segment_slice_gather
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _, log = _kernels.build()
    for name, regs, spills, smem in cs.ptxas_report(log):
        if "raster_fwd_kernel" in name or "raster_bwd_kernel" in name:
            print(f"ptxas {name}: {regs} registers, {smem} bytes smem, {spills}")

    params = activate(params_from_numpy(load_compressed_scene(str(ROOT / TRAINED_SCENE)), dev))
    sh_degree = int(round(params["features"].shape[1] ** 0.5)) - 1
    cam = scene_camera(cs.H, cs.W, device=dev)
    cfg_torch = RenderConfig(raster_impl="torch", **cs.SCENE_BUDGETS)
    cfg = RenderConfig(raster_impl="cuda", **cs.SCENE_BUDGETS)
    ts, cap = cfg.tile_size, cfg.tile_capacity
    th, tw = binning.num_tiles(cs.H, cs.W, ts)
    with torch.no_grad():
        proj = project_gaussians(params["means3d"], params["scales"], params["quats"],
                                 params["opacities"], cam, cfg_torch)
        colors = sh_to_color(params["features"], params["means3d"], cam.position, sh_degree)
        bins = binning.bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, cs.H,
                                              cs.W, cfg_torch, conics=proj.conics,
                                              opacities=params["opacities"])
        ranges = bins.tile_ranges.reshape(-1, 2)
        counts = torch.clamp(ranges[:, 1] - ranges[:, 0], 0, cap).to(torch.int32)
        slot_gids = segment_slice_gather(bins.gaussian_ids, ranges[:, 0].contiguous(), cap)
        pdata = gather_tile_data(proj.means2d, proj.conics, colors, params["opacities"],
                                 slot_gids, counts)
        rng = np.random.default_rng(1)
        gout = torch.from_numpy(rng.standard_normal(
            (th * tw, pdata.shape[0] - 5, ts * ts), dtype=np.float32)).to(dev)
        _, resid = raster_tiles_fwd(pdata, counts, ts, tw, cfg, True)
        d_pdata = raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg)
        print(json.dumps(dict(
            device=smi,
            b1_ms=cs.cuda_ms(lambda: raster_tiles(pdata, counts, ts, tw, cfg), 20, 3),
            b1_residual_ms=cs.cuda_ms(
                lambda: raster_tiles_fwd(pdata, counts, ts, tw, cfg, True), 20, 3),
            b2_ms=cs.cuda_ms(
                lambda: raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg), 20, 3),
            d_pdata_abs_sum=float(d_pdata.double().abs().sum()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
