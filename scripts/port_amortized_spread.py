"""The spread of chip_smoke.py phase 16's timing check on the card.

Phase 16 takes one reading of ``utils.metrics.amortized_ms`` and one of
``chip_smoke.cuda_ms_queued`` on the 1080p render of the trained scene
(preset 6 with tight culling) and fails when they lie more than
``AMORTIZED_MAX_REL`` apart. This script takes that pair of readings
``--readings`` times in one process, on the scene as phase 16 renders it,
and prints each pair, how far apart it is, and how many pairs lie beyond
the bound. ``--root`` names the checkout whose ``mojosplat_tpu_torch`` and
``chip_smoke.py`` are measured (default: this one), so that one command can
read an older checkout beside this one:

    python3 scripts/port_amortized_spread.py --root build/parent --readings 15
    python3 scripts/port_amortized_spread.py --readings 15

Needs a CUDA card; builds the kernels of the checkout it measures.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--readings", type=int, default=15)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_amortized_spread: no CUDA device")
    import chip_smoke as cs
    from mojosplat_tpu_torch import RenderConfig, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.metrics import amortized_ms
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    raw = load_compressed_scene(str(root / TRAINED_SCENE))
    sh_degree = int(round(raw["features"].shape[1] ** 0.5)) - 1
    p = activate(params_from_numpy(raw, dev))
    p_args = tuple(p[k] for k in cs.KEYS)
    cam = scene_camera(cs.H, cs.W, device=dev)
    cfg = RenderConfig(raster_impl="cuda", **cs.SCENE_BUDGETS)

    def render(*a):
        return render_gaussians(*a, cam, sh_degree=sh_degree, background_color=cs.BACKGROUND,
                                config=cfg)

    pairs = []
    with torch.no_grad():
        render(*p_args)  # kernel build and allocator warm-up
        for _ in range(args.readings):
            amort = amortized_ms(render, p_args, 20)
            queued = cs.cuda_ms_queued(lambda: render(*p_args), 20, 3)
            pairs.append((amort, queued, abs(amort - queued) / queued * 100))
            print(f"amortized_ms {amort:.3f} ms, cuda_ms_queued {queued:.3f} ms "
                  f"({pairs[-1][2]:.2f}% apart)", flush=True)
    apart = [x for _, _, x in pairs]
    print(json.dumps({"root": str(root), "card": smi, "readings": len(pairs),
                      "percent_apart": [round(x, 2) for x in apart],
                      "median_percent": round(statistics.median(apart), 2),
                      "max_percent": round(max(apart), 2),
                      "beyond_bound": sum(x > cs.AMORTIZED_MAX_REL * 100 for x in apart)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
