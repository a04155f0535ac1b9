"""A toy benchmark root for the harness's CPU tests: one configuration of
every 4096th gaussian of the trained scene, a train mix and an orbit mix at
64x96, their cells, limits and one metric, all written as files under a
temporary folder, as a later change would add them."""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

RING = {"radius": 3.9, "eye_y": -0.75, "target": [0.0, 0.4, 0.0], "fx_over_width": 0.72,
        "near": 0.1, "far": 100.0, "yaw0_deg": 35.408791739084876}


def config(family: str) -> dict:
    base = json.loads((REPO / "splatbench" / "configs" / f"{family}-trained-1m.json").read_text())
    base["name"] = f"toy-{family}"
    base["scene"] = {"file": "assets/trained_scene_1m.npz", "every": 4096}
    base["render"] = dict(base["render"], tile_size=16, max_tile_span=16, tile_capacity=256,
                          isect_padding_multiplier=16)
    return base


TRAIN = {"kind": "train", "height": 64, "width": 96, "ring": RING, "yaw_step_deg": 0.5,
         "views": {"count": 3, "every": 240}, "optimizer": {"name": "adam", "lr": 0.001},
         "perturb": {"means3d": 0.002, "scales": 0.05, "quats": 0.02, "opacities_raw": 0.2,
                     "features": 0.02}}
ORBIT = {"kind": "orbit", "height": 64, "width": 96, "ring": RING, "yaw_step_deg": 0.5,
         "sample_frames": 2, "trace_poses": 2}
# Set over seeds at this size (toy readings: loss 2e-6-4e-5, gradients
# 7e-7-3e-5, updates 7e-7-7e-4, maps 6e-6-2e-3 by the distortion map's
# cancellation), well under what the planted faults read.
TRAIN_LIMITS = {"checked_steps": 3,
                "loss_rel_gap": {"limit": 1e-3}, "grad_norm_gap": {"limit": 1e-3},
                "update_norm_gap": {"limit": 1e-2}, "isects_rel_gap": {"limit": 1e-3},
                "maps_rel_l2": {"limit": 2e-2}, "dropped": {"limit": 0}}
ORBIT_LIMITS = {"image_rel_l2": {"limit": 1e-3}, "T_rel_l2": {"limit": 1e-3},
                "isects_rel_gap": {"limit": 1e-3}, "dropped": {"limit": 0}}
TOY_METRIC = '''"""Frames or steps the traced window completed."""


def read(ctx):
    return float(ctx["units"])
'''


def write_root(root: Path) -> Path:
    """The toy benchmark under ``root``; returns ``root``."""
    sb = root / "splatbench"
    for d in ("configs", "traffic", "checks", "metrics"):
        (sb / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for fam in ("3dgs", "2dgs"):
        c = config(fam)
        (sb / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        bench["configs"].append({"name": c["name"], "source": c["source"],
                                 "file": f"splatbench/configs/{c['name']}.json",
                                 "reduced": ["num_gaussians"], "why": "toy"})
        for kind, limits in (("train", TRAIN_LIMITS), ("orbit", ORBIT_LIMITS)):
            name = f"toy-{fam}-{kind}"
            bench["workloads"].append({"name": name, "config": c["name"], "traffic": f"toy_{kind}",
                                       "chips": 1, "why": "toy"})
            if fam == "3dgs":
                limits = {k: v for k, v in limits.items() if k != "maps_rel_l2"}
            (sb / "checks" / f"{name}.json").write_text(json.dumps(limits))
    (sb / "traffic" / "toy_train.json").write_text(json.dumps(TRAIN))
    (sb / "traffic" / "toy_orbit.json").write_text(json.dumps(ORBIT))
    for m in bench["per_layer"]:
        m["workloads"] = [w["name"] for w in bench["workloads"]]
        src = REPO / "splatbench" / "metrics" / f"{m['name']}.py"
        (sb / "metrics" / src.name).write_text(src.read_text())
    for m in bench["end_to_end"]:
        if "workloads" in m:
            kind = "train" if m["name"].startswith("train") else "orbit"
            m["workloads"] = [w["name"] for w in bench["workloads"] if w["name"].endswith(kind)]
    bench["per_layer"].append({"name": "toy_units", "unit": "units", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "setup_s"})
    (sb / "metrics" / "toy_units.py").write_text(TOY_METRIC)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
