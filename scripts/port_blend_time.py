#!/usr/bin/env python3
"""Time the blend kernels at the trained scene's 1080p shapes, on one
NVIDIA GPU: the 3DGS blend B1 and its backward B2 (the default), or the
2DGS surfel blends B6 and B7 and their backward B8.

Run from the root of a checkout (its kernels are built there):

    python3 scripts/port_blend_time.py [--family 3dgs|2dgs]

3DGS: chip_smoke.py phase 4's inputs, the trained 1M-gaussian scene at
1920x1080 with preset 6's budgets (tight_cull), binned on the "torch"
route; B2 gets a seeded output cotangent. 2DGS: phase 9's, the scene read
as disks (its first two log-scales), its slot tables without the maps (B6)
and with them (B7, whose residual B8 reads); B8 gets a seeded cotangent.
Prints the family's ptxas lines (registers, shared memory, spills), the
launch shapes (B2's; or B6's and B7's, without and with the residual, and
B8's) and, as its last line, one JSON object: each
kernel's time (median of 20 CUDA-event runs after 3 warm-ups,
chip_smoke.cuda_ms; the forward also with its residual written), the
card's name and power limit, and the sum of |d pdata| (to tell two
designs' outputs apart). To compare two designs of a kernel, run the
script in each tree in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def time_3dgs(cs, params, sh_degree, cam, dev) -> dict:
    from mojosplat_tpu_torch import RenderConfig
    from mojosplat_tpu_torch.ops import binning
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.raster_cuda import (
        gather_tile_data, raster_bwd_shape, raster_tiles, raster_tiles_bwd, raster_tiles_fwd)
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.slice_cuda import segment_slice_gather

    cfg_torch = RenderConfig(raster_impl="torch", **cs.SCENE_BUDGETS)
    cfg = RenderConfig(raster_impl="cuda", **cs.SCENE_BUDGETS)
    ts, cap = cfg.tile_size, cfg.tile_capacity
    th, tw = binning.num_tiles(cs.H, cs.W, ts)
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
    print(f"B2 launch shape {json.dumps(raster_bwd_shape(pdata.shape[0] - 6, ts))}")
    return dict(
        b1_ms=cs.cuda_ms(lambda: raster_tiles(pdata, counts, ts, tw, cfg), 20, 3),
        b1_residual_ms=cs.cuda_ms(
            lambda: raster_tiles_fwd(pdata, counts, ts, tw, cfg, True), 20, 3),
        b2_ms=cs.cuda_ms(
            lambda: raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg), 20, 3),
        d_pdata_abs_sum=float(d_pdata.double().abs().sum()))


def time_2dgs(cs, params, sh_degree, cam, dev) -> dict:
    from mojosplat_tpu_torch import RenderConfig
    from mojosplat_tpu_torch.ops.binning import num_tiles
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.surfel_cuda import (
        raster_surfel_tiles, raster_surfel_tiles_bwd, raster_surfel_tiles_fwd, surfel_bwd_shape,
        surfel_fwd_shape)
    from mojosplat_tpu_torch.surfel import bin_surfels, pack_surfel_tiles

    cfg = RenderConfig(raster_impl="cuda", **cs.SCENE_BUDGETS)
    ts = cfg.tile_size
    th, tw = num_tiles(cs.H, cs.W, ts)
    geometry = [params[k] for k in ("means3d", "scales", "quats", "opacities")]
    bins = bin_surfels(*geometry, cam, cfg)
    colors = sh_to_color(params["features"], params["means3d"], cam.position, sh_degree)
    out = {}
    for aux, kid in ((False, "b6"), (True, "b7")):
        for resid in (False, True):
            print(f"{kid.upper()} launch shape{' with the residual' if resid else ''} "
                  f"{json.dumps(surfel_fwd_shape(aux, ts, resid))}")
        pdata, counts = pack_surfel_tiles(*geometry, colors, cam, bins, cfg, aux)
        out[f"{kid}_ms"] = cs.cuda_ms(
            lambda: raster_surfel_tiles(pdata, counts, ts, tw, cfg, aux), 20, 3)
        out[f"{kid}_residual_ms"] = cs.cuda_ms(
            lambda: raster_surfel_tiles_fwd(pdata, counts, ts, tw, cfg, aux, True), 20, 3)
    _, resid = raster_surfel_tiles_fwd(pdata, counts, ts, tw, cfg, True, True)
    rng = np.random.default_rng(2)
    gout = torch.from_numpy(
        rng.standard_normal((th * tw, 9, ts * ts), dtype=np.float32)).to(dev)
    d_pdata = raster_surfel_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg, True)
    print(f"B8 launch shape {json.dumps(surfel_bwd_shape(True, ts))}")
    out["b8_ms"] = cs.cuda_ms(
        lambda: raster_surfel_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg, True), 20, 3)
    out["d_pdata_abs_sum"] = float(d_pdata.double().abs().sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("3dgs", "2dgs"), default="3dgs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_blend_time: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mojosplat_tpu_torch import _kernels
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _, log = _kernels.build()
    names = ("surfel_fwd_kernel", "surfel_bwd_kernel") if args.family == "2dgs" else (
        "raster_fwd_kernel", "raster_bwd_kernel")
    for name, regs, spills, smem in cs.ptxas_report(log):
        if any(k in name for k in names):
            print(f"ptxas {name}: {regs} registers, {smem} bytes smem, {spills}")

    raw = load_compressed_scene(str(ROOT / TRAINED_SCENE))
    if args.family == "2dgs":
        raw = dict(raw, scales=np.ascontiguousarray(raw["scales"][:, :2]))
    params = activate(params_from_numpy(raw, dev))
    sh_degree = int(round(params["features"].shape[1] ** 0.5)) - 1
    cam = scene_camera(cs.H, cs.W, device=dev)
    timer = time_2dgs if args.family == "2dgs" else time_3dgs
    with torch.no_grad():
        out = timer(cs, params, sh_degree, cam, dev)
    print(json.dumps(dict(device=smi, family=args.family, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
