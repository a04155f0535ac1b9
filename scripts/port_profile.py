#!/usr/bin/env python3
"""Where the time of the PyTorch port's training step (or render) goes, on
one NVIDIA GPU.

Run from the repository root:

    python3 scripts/port_profile.py [--family 3dgs|2dgs] [--mode train|render|bin]
                                    [--aabb] [--steps 5]

The setup is chip_smoke.py's: the trained 1M-gaussian scene at 1920x1080,
SH degree 3, its budgets (bench.py's preset 6: tile_size 32,
max_tile_span 4, 8x capacity, tile_capacity 512, tight_cull; ``--aabb``
turns the culling off), the "cuda" route; ``bin`` times the 3DGS binning
alone on the scene's projection; for ``train``, Adam from the same
seeded perturbation towards the render of the unperturbed scene. With
``--family 2dgs`` the scene is read as disks (its first two log-scales),
rendered by ``render_surfels`` with the depth, normal and distortion maps,
and trained by ``train_step_surfel`` with chip_smoke.py's regulariser
weights. After 3 warm-up steps it prints

  - the median time of ``--steps`` unprofiled steps (host clock around each
    step, ending in a synchronize);
  - from ``--steps`` steps under ``torch.profiler`` (CPU and CUDA
    activities): the device time per step by kernel (the 30 largest of
    ``key_averages()``'s device events by self device time) and the device
    busy time per step, their sum (one stream, so kernels do not overlap);
  - the idle share, 1 - busy / unprofiled step time;
  - for ``train``, the device time per step of the slot gather's adjoint
    (``raster_cuda._GatherRows.backward``) split by the operations it
    calls: the sort, the payload's ``index_select`` where there is one,
    the allocations and copies, and the kernels it launches itself
    (B3);

and, as its last line, the same numbers as one JSON object. It needs no
network and no jax.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def device_us(evt) -> float:
    """Self device time of a profiler average, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_total_us(evt) -> float:
    """Device time of a profiler event and of everything it called, in
    microseconds."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def adjoint_split(prof, steps: int) -> dict:
    """Device ms per step of the slot gather's adjoint, by the operations
    it calls (the name of each child event of ``_GatherRowsBackward``) and
    ``launched directly``: the kernels it launches outside any operation,
    B3 through its ctypes entry point."""
    split: dict[str, float] = {}
    total = 0.0
    for evt in prof.events():
        if evt.name != "_GatherRowsBackward":
            continue
        total += device_total_us(evt)
        rest = device_total_us(evt)
        for child in evt.cpu_children:
            us = device_total_us(child)
            split[child.name] = split.get(child.name, 0.0) + us
            rest -= us
        split["launched directly"] = split.get("launched directly", 0.0) + rest
    return dict(total_ms=total / 1e3 / steps,
                parts_ms={k: v / 1e3 / steps for k, v in split.items() if v > 0})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("3dgs", "2dgs"), default="3dgs")
    ap.add_argument("--mode", choices=("train", "render", "bin"), default="train")
    ap.add_argument("--aabb", action="store_true", help="preset 6 without tight_cull")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if args.mode == "bin" and args.family != "3dgs":
        raise SystemExit("port_profile: --mode bin profiles the 3DGS binning")
    if not torch.cuda.is_available():
        raise SystemExit("port_profile: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (
        H, PERTURB, SCENE_BUDGETS, SURFEL_WEIGHTS, TRAIN_LR, TRAIN_SEED, W)
    from mojosplat_tpu_torch import RenderConfig, render_gaussians, render_surfels
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.train import (
        activate, make_optimizer, train_step, train_step_surfel)
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    raw = load_compressed_scene(str(ROOT / TRAINED_SCENE))
    sh_degree = int(round(raw["features"].shape[1] ** 0.5)) - 1
    cam = scene_camera(H, W, device=dev)
    cfg = RenderConfig(raster_impl="cuda", **dict(SCENE_BUDGETS, tight_cull=not args.aabb))
    keys = ("means3d", "scales", "quats", "opacities", "features")
    if args.family == "2dgs":
        raw = dict(raw, scales=np.ascontiguousarray(raw["scales"][:, :2]))
        maps = dict(return_depth=True, return_normals=True, return_distortion=True)

        def render(p, **kw):
            return render_surfels(*(p[k] for k in keys), cam, sh_degree=sh_degree, config=cfg,
                                  **kw)

        def train(leaves, opt, target):
            train_step_surfel(leaves, opt, [cam], target[None], sh_degree=sh_degree,
                              config=cfg, **SURFEL_WEIGHTS)
    else:
        maps = {}

        def render(p, **kw):
            return render_gaussians(*(p[k] for k in keys), cam, sh_degree=sh_degree,
                                    config=cfg, **kw)

        def train(leaves, opt, target):
            train_step(leaves, opt, [cam], target[None], sh_degree=sh_degree, config=cfg)

    if args.mode == "train":
        with torch.no_grad():
            target = render(activate(params_from_numpy(raw, dev)))
        rng = np.random.default_rng(TRAIN_SEED)
        leaves = {
            k: torch.from_numpy(v + rng.standard_normal(v.shape, dtype=np.float32) * PERTURB[k])
            .to(dev).requires_grad_(True)
            for k, v in raw.items()
        }
        opt = make_optimizer(leaves, lr=TRAIN_LR)

        def step():
            train(leaves, opt, target)
    elif args.mode == "bin":
        p = activate(params_from_numpy(raw, dev))
        with torch.no_grad():
            proj = project_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                                     cam, cfg)

        def step():
            bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, H, W, cfg,
                                   conics=proj.conics, opacities=p["opacities"])
    else:
        p = activate(params_from_numpy(raw, dev))

        def step():
            with torch.no_grad():
                render(p, background_color=(0.1, 0.1, 0.1), **maps)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(wall)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    # Device-side events only: a CPU op's self device time repeats that of
    # the kernels it launched. A device event named like a host event is a
    # range annotation (the optimizer's step, for one) spanning kernels that
    # are listed on their own.
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    rows = [(e.key, device_us(e) / 1e3 / args.steps, e.count / args.steps)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host
            and not getattr(e, "is_user_annotation", False)]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"{args.family} {args.mode}: median of {args.steps} unprofiled steps {step_ms:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in wall)}); under the profiler {profiled_ms:.3f} ms")
    print(f"device busy per step {busy_ms:.3f} ms; idle share {1 - busy_ms / step_ms:.4f} "
          f"of the unprofiled step")
    print(f"{'device ms/step':>14} {'share':>7} {'calls/step':>10}  kernel")
    for name, ms, calls in rows[:30]:
        print(f"{ms:14.4f} {ms / busy_ms:7.2%} {calls:10.1f}  {name[:110]}")
    adjoint = adjoint_split(prof, args.steps) if args.mode == "train" else None
    if adjoint is not None:
        print(f"gather adjoint per step {adjoint['total_ms']:.4f} ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in adjoint["parts_ms"].items()))
    print(json.dumps(dict(
        family=args.family, mode=args.mode, tight_cull=cfg.tight_cull,
        device=torch.cuda.get_device_name(0),
        nvidia_smi=smi,
        steps=args.steps, step_ms=step_ms, wall_ms=wall, profiled_step_ms=profiled_ms,
        device_busy_ms=busy_ms, idle_share=1 - busy_ms / step_ms,
        kernels=[dict(name=n, ms=m, calls=c) for n, m, c in rows[:30]],
        gather_adjoint=adjoint)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
