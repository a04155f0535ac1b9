"""The no-drop render budgets of a configuration over its cells' traffic.

    python3 splatbench/tools/budgets.py --config 3dgs-trained-1m \\
        --traffic train_ring_1080p orbit_1080p [--seeds 4] [--train-steps 300] [--out FILE]

For every pose each mix can ask for (the orbit's whole ring, the train
mix's capture views at several seeds' perturbed starts and after
``--train-steps`` steps of training), the port's own projection and
binning run at budgets too large to drop anything, and give the
intersections and the largest per-tile count; the widest screen rectangle
comes from the plain reference's binning rule. The budgets are the
smallest that hold those maxima with 10% room (2 tiles of span), and every
pose is rendered again at them through the port's counters, which must
read no drop. Prints, and writes to ``--out``, one JSON report. Runs on
the card by default; ``--device cpu`` at the configuration's sizes is far
too slow, so tests call ``measure`` on a toy root.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from splatbench.harness import cells, program, traffic  # noqa: E402
from splatbench.harness.scene import load_scene, perturbed  # noqa: E402
from splatbench.reference import render as ref  # noqa: E402

ROOM = 1.1


def counters(family: str, params: dict, pose: dict, cfg, rules, dev) -> dict:
    """The port's binning of one pose: intersections, the largest tile,
    and its drop counters; the widest rectangle by the reference's rule."""
    from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.surfel import bin_surfels

    cam = program.camera(pose, dev)
    g = (params["means3d"], params["scales"], params["quats"], params["opacities"])
    with torch.no_grad():
        if family == "3dgs":
            proj = project_gaussians(*g, cam, cfg)
            bins = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, cam.H, cam.W, cfg,
                                          conics=proj.conics, opacities=params["opacities"])
        else:
            bins = bin_surfels(*g, cam, cfg)
        counts = bins.tile_ranges[..., 1] - bins.tile_ranges[..., 0]
    widest = widest_span(family, params, pose, rules, dev)
    return dict(yaw=pose["yaw_deg"], isects=int(bins.aux.num_isects), tile_max=int(counts.max()),
                widest=widest, capacity_overflow=int(bins.aux.capacity_overflow),
                span_truncated=int(bins.aux.span_truncated), tile_overflow=max(
                    0, int(counts.max()) - cfg.tile_capacity))


def widest_span(family: str, params: dict, pose: dict, rules, dev) -> int:
    view = cells.ref_view(pose, dev)
    with torch.no_grad():
        p = dict(params, features=params["features"][:, :1])
        _, tiles = ref.fields_of(family, p, view, rules, 0)
    return tiles.widest


def measure(config: dict, mixes: list[dict], raw: dict, dev, seeds: int, train_steps: int,
            train_cell=None, log=print) -> dict:
    """Maxima over every pose of the mixes (and the train mixes' perturbed
    starts and trained states), the budgets they give, and the check of
    every pose at those budgets."""
    family = config["family"]
    rules = ref.Rules.of(config["render"])
    probe = program.render_config(dict(config, render=dict(
        config["render"], max_tile_span=255, isect_padding_multiplier=32, tight_cull=False)))
    act = ref.activate(raw)
    states = []  # (label, activated params, poses)
    for mix in mixes:
        poses = [traffic.pose(mix, k) for k in traffic.all_pose_ids(mix)]
        states.append((f"{mix['kind']} scene", act, poses))
        if mix["kind"] == "train":
            for s in range(1, seeds + 1):
                gen = torch.Generator(device=dev)
                gen.manual_seed(s)
                states.append((f"train seed {s}", ref.activate(perturbed(raw, mix["perturb"], gen)),
                               poses))
    if train_cell is not None and train_steps:
        cell = train_cell
        cell.setup()
        for _ in range(train_steps):
            cell.step(cell.order.next())
        states.append((f"after {train_steps + cell.steps} steps",
                       ref.activate({k: v.detach() for k, v in cell.leaves.items()}), cell.poses))
    rows, worst = [], dict(isects=0, tile_max=0, widest=0)
    for label, p, poses in states:
        t = time.perf_counter()
        for pose in poses:
            c = counters(family, p, pose, probe, rules, dev)
            c["state"] = label
            rows.append(c)
            for k in worst:
                worst[k] = max(worst[k], c[k])
        log(f"{label}: {len(poses)} poses in {time.perf_counter() - t:.1f} s; running maxima "
            f"{json.dumps(worst)}")
    n = raw["means3d"].shape[0]
    chunk = program.render_config(config).chunk_size
    budgets = dict(
        max_tile_span=min(255, worst["widest"] + 2),
        tile_capacity=int(math.ceil(worst["tile_max"] * ROOM / chunk) * chunk),
        isect_padding_multiplier=int(math.ceil(worst["isects"] * ROOM / n)),
        tight_cull=False)
    cfg = program.render_config(dict(config, render=dict(config["render"], **budgets)))
    drops = 0
    for label, p, poses in states:
        for pose in poses:
            c = counters(family, p, pose, cfg, rules, dev)
            drops += c["capacity_overflow"] + c["span_truncated"] + c["tile_overflow"]
    return dict(config=config["name"], gaussians=n, maxima=worst, budgets=budgets,
                drops_at_budgets=drops, poses_checked=sum(len(s[2]) for s in states),
                per_pose=rows)


def main(argv=None) -> int:
    from splatbench.harness.spec import Spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    config = json.loads((ROOT / entry["file"]).read_text())
    mixes = [json.loads((ROOT / "splatbench" / "traffic" / f"{t}.json").read_text())
             for t in args.traffic]
    raw = load_scene(ROOT / config["scene"]["file"], config["family"], dev,
                     config["scene"].get("every", 1))
    train_cell = None
    trains = [w for w in bench["workloads"]
              if w["config"] == args.config and w["traffic"] in args.traffic
              and mixes[args.traffic.index(w["traffic"])]["kind"] == "train"]
    if trains and args.train_steps:
        spec = Spec(trains[0]["name"])
        spec.config = dict(config, render=dict(config["render"], max_tile_span=255,
                                               isect_padding_multiplier=16, tile_capacity=16384))
        train_cell = cells.build(spec, 1, dev)
    report = measure(config, mixes, raw, dev, args.seeds, args.train_steps, train_cell)
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    summary = {k: v for k, v in report.items() if k != "per_pose"}
    print(json.dumps(summary))
    return 0 if report["drops_at_budgets"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
