#!/usr/bin/env python3
"""Time the segment expansion B4 at the trained scene's shapes beside
torch.repeat_interleave, on one NVIDIA GPU.

Run from anywhere, naming the checkout whose package and kernels to use
(default: this script's own):

    python3 scripts/port_expand_time.py [ROOT]

The inputs are chip_smoke.py phase 4's: the trained 1M-gaussian scene at
1920x1080 with preset 6's budgets, projected and presorted on the "torch"
route; B4 expands the presort's (5, 1,048,576) int32 fields to the
8,388,608-slot capacity, repeat_interleave the 3,662,569 demanded slots.
Prints one JSON line: whether B4 equals its plain version on every column
and on the slots below the total, and, twice each, B4's and
repeat_interleave's time (median of 50 CUDA-event runs after 5 warm-ups,
chip_smoke.cuda_ms). To compare two designs of B4, run it on each tree in
one call.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parent.parent).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("port_expand_time: torch.cuda.is_available() is False")
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mojosplat_tpu_torch import RenderConfig
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops import binning
    from mojosplat_tpu_torch.ops.expand_cuda import (
        segment_expand_offsets, segment_expand_offsets_plain)
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    dev = torch.device("cuda", 0)
    params = activate(params_from_numpy(load_compressed_scene(str(root / TRAINED_SCENE)), dev))
    n = params["means3d"].shape[0]
    cam = scene_camera(cs.H, cs.W, device=dev)
    cfg = RenderConfig(raster_impl="torch", **cs.SCENE_BUDGETS)
    th, tw = binning.num_tiles(cs.H, cs.W, cfg.tile_size)
    with torch.no_grad():
        proj = project_gaussians(params["means3d"], params["scales"], params["quats"],
                                 params["opacities"], cam, cfg)
        pre = binning.presort_gaussians(proj.means2d, proj.radii, proj.depths, th, tw, cfg,
                                        proj.conics, params["opacities"])
        capacity = binning.isect_capacity(n, cfg)
        total = int(pre.total)
        got = segment_expand_offsets(pre.fields, capacity)
        want = segment_expand_offsets_plain(pre.fields, capacity)
        repeats = torch.diff(pre.fields[0], append=pre.total.reshape(1))
        res = dict(tree=str(root), device=torch.cuda.get_device_name(0), n=n,
                   capacity=capacity, total=total,
                   equal_all=bool(torch.equal(got, want)),
                   equal_live=bool(torch.equal(got[:, :total], want[:, :total])))
        for i in range(2):
            res[f"b4_ms_{i}"] = cs.cuda_ms(
                lambda: segment_expand_offsets(pre.fields, capacity), 50, 5)
            res[f"repeat_interleave_ms_{i}"] = cs.cuda_ms(lambda: torch.repeat_interleave(
                pre.fields, repeats, dim=1, output_size=total), 50, 5)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
