"""Multi-card scaling sweep: a sharded training step's pixels/s against the
number of ranks.

Port of ``examples/benchmark_scaling.py``. Launch one process per rank,
under ``torchrun``

    torchrun --nproc-per-node 4 -m mojosplat_tpu_torch.examples.benchmark_scaling \\
        --multihost --pipeline both

or with the MOJOSPLAT_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID variables
(``parallel.init_multihost``); a single process runs a world of one. For
each device count d of the sweep (1, 2, 4, ... up to the world, or
``--devices``) the first d ranks form the mesh and time one step with
``utils.metrics.amortized_ms``; rank 0 prints one JSON line per point.

  - ``dp-sp``: camera-DP x tile-row-SP (``train.train_step_sharded``):
    replicated parameters, all-reduced gradients; a (2, d / 2) mesh for
    even d, one camera per data row.
  - ``gauss``: the gaussian-sharded all-to-all pipeline
    (``parallel.train_step_gauss_sharded``): parameters, gradients and Adam
    moments sharded (ZeRO-3); the height is rounded up to whole slabs.

This is a sweep for users, not the port's benchmark: it writes no file and
nothing reads its lines as a metric. On one card it runs d = 1 only.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from mojosplat_tpu_torch import Camera, RenderConfig
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.parallel import (
    init_multihost, is_primary, make_gauss_mesh, make_mesh, train_step_gauss_sharded)
from mojosplat_tpu_torch.parallel.sharding import batch_block
from mojosplat_tpu_torch.utils.metrics import amortized_ms


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--sh-degree", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL), or cpu (gloo)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"])
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="device counts to sweep (default: 1, 2, 4, ... up to the world)")
    ap.add_argument("--pipeline", default="dp-sp", choices=["dp-sp", "gauss", "both"],
                    help="'dp-sp': camera-DP x tile-SP with replicated parameters; "
                    "'gauss': the gaussian-sharded all-to-all pipeline (ZeRO-3)")
    ap.add_argument("--multihost", action="store_true",
                    help="require a multi-process rendezvous (torchrun or the "
                    "MOJOSPLAT_* variables)")
    return ap


def _cameras(n: int, H: int, W: int, device) -> list[Camera]:
    return [Camera.create(R=torch.eye(3), T=torch.zeros(3), H=H, W=W, fx=0.5 * W, fy=0.5 * W,
                          cx=W / 2, cy=H / 2, device=device) for _ in range(n)]


def _params(n: int, sh_degree: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return mtrain.init_gaussians(n, sh_degree=sh_degree, generator=gen, device=device)


def scaling_point(d: int, args, config: RenderConfig, device, pipeline: str) -> dict | None:
    """Time one sharded training step on the first d ranks; None on the
    ranks outside the mesh (which still take part in building it)."""
    H, W = args.height, args.width
    if pipeline == "gauss":
        mesh = make_gauss_mesh(d, device=device)
        if mesh.rank is None:
            return None
        # One camera; the height split into whole tile-row slabs.
        Hg = -(-H // (d * config.tile_size)) * d * config.tile_size
        full = _params(args.gaussians, args.sh_degree, device)
        n = args.gaussians // d
        params = {k: v[mesh.rank * n:(mesh.rank + 1) * n].clone().requires_grad_(True)
                  for k, v in full.items()}
        del full
        opt = mtrain.make_optimizer(params)
        cam = _cameras(1, Hg, W, device)[0]
        target = torch.zeros((Hg // d, W, 3), device=device)
        ms = amortized_ms(lambda t: train_step_gauss_sharded(
            params, opt, cam, t, mesh, sh_degree=args.sh_degree, config=config),
            (target,), iters=args.iterations)
        return {"devices": d, "mesh": {"gauss": d}, "pipeline": pipeline, "step_ms": ms,
                "pixels_per_s": Hg * W / (ms * 1e-3)}

    n_data = 2 if d % 2 == 0 and d > 1 else 1
    mesh = make_mesh(n_data, d // n_data, device=device)
    if mesh.rank is None:
        return None
    params = {k: v.requires_grad_(True)
              for k, v in _params(args.gaussians, args.sh_degree, device).items()}
    opt = mtrain.make_optimizer(params)
    cams = _cameras(n_data, H, W, device)  # one camera per data row
    block = batch_block(torch.zeros((n_data, H, W, 3), device=device), mesh)
    ms = amortized_ms(lambda t: mtrain.train_step_sharded(
        params, opt, cams, t, mesh, sh_degree=args.sh_degree, config=config),
        (block,), iters=args.iterations)
    return {"devices": d, "mesh": {"data": n_data, "tile": d // n_data}, "pipeline": pipeline,
            "step_ms": ms, "pixels_per_s": n_data * H * W / (ms * 1e-3)}


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, args.impl)
    init_multihost(require=args.multihost, backend="gloo" if device.type == "cpu" else None,
                   world_of_one=True)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return _sweep(args, device)
    finally:
        dist.destroy_process_group()


def _sweep(args, device) -> list[dict]:
    # Every rank takes part in every collective; only the primary prints.
    say = print if is_primary() else (lambda *a, **k: None)
    world = dist.get_world_size()
    counts = args.devices or [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    config = RenderConfig(raster_impl=args.impl)
    say(f"device={device.type} world={world}")
    pipelines = ["dp-sp", "gauss"] if args.pipeline == "both" else [args.pipeline]
    results, by_pipe = [], {p: [] for p in pipelines}
    for d in counts:
        for pipe in pipelines:
            if pipe == "gauss" and args.gaussians % d != 0:
                say(f"skipping d={d}: gaussians not divisible by device count "
                    "(sharded leading axis)")
                continue
            r = scaling_point(d, args, config, device, pipe)
            if r is None:
                continue
            results.append(r)
            by_pipe[pipe].append(r)
            say(json.dumps(r))

    if args.pipeline == "both":
        # The routed pipeline's cost over the replicated step at equal
        # device count, per pixel (the two render different pixel counts).
        dp = {r["devices"]: r for r in by_pipe["dp-sp"]}
        for r in by_pipe["gauss"]:
            d = r["devices"]
            if d in dp:
                rel = r["pixels_per_s"] / max(dp[d]["pixels_per_s"], 1e-9)
                say(f"routed-vs-replicated @ {d} device(s): {r['pixels_per_s'] / 1e6:.2f} vs "
                    f"{dp[d]['pixels_per_s'] / 1e6:.2f} Mpix/s ({rel:.1%} of replicated)")

    if len(results) > 1:
        base = results[0]
        say(f"\n{'devices':>8} {'step_ms':>10} {'Mpix/s':>10} {'efficiency':>11}")
        for r in results:
            lin = base["pixels_per_s"] * r["devices"] / base["devices"]
            say(f"{r['devices']:>8} {r['step_ms']:>10.2f} {r['pixels_per_s'] / 1e6:>10.2f} "
                f"{r['pixels_per_s'] / lin:>10.1%}")
    return results


if __name__ == "__main__":
    main()
