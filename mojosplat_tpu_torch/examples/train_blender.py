"""Train a 3DGS scene on a NeRF-synthetic (Blender transforms.json) capture.

Port of ``examples/train_blender.py``, the synthetic-benchmark counterpart
of train_colmap: no SfM points exist, so gaussians start as a random cloud
inside the camera rig's working volume, trained against the
white-composited RGBA renders with the D-SSIM + L1 loss, evaluated on the
held-out test split.

    python -m mojosplat_tpu_torch.examples.train_blender --data /path/to/lego --steps 2000

runs on the card through the CUDA kernels (``--device cuda --impl cuda``,
the defaults); ``--device cpu --impl torch`` on the CPU. The cloud and
the MCMC draws come from ``torch.Generator``s seeded as the reference's
keys (0 and 23); the numbers differ from the reference's ``jax.random``
draws. The views are drawn from ``np.random.default_rng(0)`` as in the
reference.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mojosplat_tpu_torch import RenderConfig, render_gaussians
from mojosplat_tpu_torch import densify
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.examples.train_colmap import _leaves, resolve_device
from mojosplat_tpu_torch.utils import save_gaussian_ply, save_png
from mojosplat_tpu_torch.utils.blender import load_blender_scene

INIT_SEED, MCMC_SEED = 0, 23


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="scene dir with transforms_{train,test}.json")
    ap.add_argument("--downscale", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--gaussians", type=int, default=65536)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ssim-weight", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    ap.add_argument("--tile-capacity", type=int, default=512)
    ap.add_argument("--background", type=float, nargs=3, default=(1.0, 1.0, 1.0))
    ap.add_argument("--out-dir", default="output/train_blender")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out test-split PSNR every N steps")
    ap.add_argument("--strategy", default="none", choices=["none", "mcmc"],
                    help="'mcmc' = 3DGS-MCMC density control (relocation + "
                    "opacity-gated noise + L1 regularizers) at fixed "
                    "capacity: fills the random-init cloud with detail")
    ap.add_argument("--densify-every", type=int, default=100,
                    help="steps between MCMC relocation events")
    return ap


def blender_config(args) -> RenderConfig:
    return RenderConfig(tile_capacity=args.tile_capacity, chunk_size=64, max_tile_span=8,
                        tile_batch=512, raster_impl=args.impl, pallas_chunk=128)


def rig_init(scene, args, device) -> dict:
    """The random cloud inside the camera rig's working volume: the cameras
    orbit the object at a roughly constant radius, and the object sits
    around the origin within ~40% of it."""
    cam_pos = np.stack([-scene.R[i].T @ scene.T[i] for i in range(len(scene.names))])
    rig_radius = float(np.median(np.linalg.norm(cam_pos, axis=-1)))
    gen = torch.Generator(device=device)
    gen.manual_seed(INIT_SEED)
    return mtrain.init_gaussians(args.gaussians, sh_degree=args.sh_degree,
                                 position_scale=0.4 * rig_radius / 2.0, log_scale_mean=-4.0,
                                 generator=gen, device=device)


def render_view(params: dict, cam, args, config: RenderConfig) -> torch.Tensor:
    p = mtrain.activate(params)
    return render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                            p["features"], cam, sh_degree=args.sh_degree,
                            background_color=args.background, config=config)


def eval_test(params: dict, args, config: RenderConfig, device):
    """Mean test-split PSNR and the number of views, or None without a
    ``transforms_test.json`` (the loader would fall back to
    transforms.json and score the training views)."""
    if not os.path.exists(os.path.join(args.data, "transforms_test.json")):
        return None
    test = load_blender_scene(args.data, "test", background=args.background,
                              downscale=args.downscale)
    if test.images is None or not len(test.names):
        return None
    vals = []
    with torch.no_grad():
        for i in range(len(test.names)):
            img = render_view(params, test.camera_for(i, device=device), args, config)
            vals.append(float(mtrain.psnr(img, torch.from_numpy(test.images[i]).to(device))))
    return float(np.mean(vals)), len(vals)


def main(argv=None, on_step=None) -> dict:
    """Run the CLI on ``argv``; ``on_step(step, loss)`` is called after
    every step. Returns the losses (floats), the MCMC events, the final
    test-split PSNR (None without a test split) and the initial raw
    parameters."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SSIM blurs
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out_dir, exist_ok=True)

    scene = load_blender_scene(args.data, "train", background=args.background,
                               downscale=args.downscale)
    if scene.images is None or not len(scene.names):
        raise SystemExit("no training frames found")
    print(f"{len(scene.names)} train views at {scene.W}x{scene.H} (fx {scene.fx:.1f})")
    targets = torch.from_numpy(scene.images).to(dev)
    cameras = [scene.camera_for(i, device=dev) for i in range(len(scene.names))]

    raw = rig_init(scene, args, dev)
    initial = {k: v.clone() for k, v in raw.items()}
    params = _leaves(raw)
    config = blender_config(args)
    optimizer = mtrain.make_optimizer(params, args.lr)
    mcmc = args.strategy == "mcmc"
    gen = torch.Generator(device=dev)
    gen.manual_seed(MCMC_SEED)

    n_views = len(scene.names)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    losses, events = [], []
    for step in range(args.steps):
        i = int(rng.integers(n_views))
        optimizer.zero_grad(set_to_none=True)
        img = render_view(params, cameras[i], args, config)
        loss = mtrain.dssim_l1_loss(img, targets[i], ssim_weight=args.ssim_weight)
        if mcmc:
            loss = loss + densify.mcmc_regularization(params)
        loss.backward()
        optimizer.step()
        if mcmc:
            with torch.no_grad():
                params["means3d"].copy_(
                    densify.mcmc_position_noise(params, gen, args.lr)["means3d"])
        losses.append(loss.detach())
        if mcmc and (step + 1) % args.densify_every == 0 and step + 1 < args.steps:
            new, m = densify.mcmc_relocate(params, gen)
            params = _leaves(new)
            optimizer = mtrain.make_optimizer(params, args.lr)
            m = {k: int(v) for k, v in m.items()}
            events.append(dict(step=step + 1, **m))
            print(f"  [mcmc: {m['relocated']} relocated, {m['alive']} alive]", flush=True)
        if (step + 1) % 50 == 0:
            lv = float(torch.stack(losses[-50:]).mean())
            dt = time.perf_counter() - t0
            print(f"step {step + 1:5d}  loss {lv:.5f}  {(step + 1) / dt:.2f} steps/s",
                  flush=True)
        if args.eval_every and (step + 1) % args.eval_every == 0:
            ev = eval_test(params, args, config, dev)
            if ev:
                print(f"  test PSNR {ev[0]:.2f} dB over {ev[1]} views", flush=True)
        if on_step is not None:
            on_step(step, loss)

    save_gaussian_ply(os.path.join(args.out_dir, "scene_final.ply"), params)
    with torch.no_grad():
        img = render_view(params, cameras[0], args, config)
    save_png(img.cpu().numpy(), os.path.join(args.out_dir, "render_view0.png"))
    save_png(scene.images[0], os.path.join(args.out_dir, "target_view0.png"))
    ev = eval_test(params, args, config, dev)
    if ev:
        print(f"final test PSNR {ev[0]:.2f} dB over {ev[1]} views")
    print(f"Done: artifacts in {args.out_dir}")
    return dict(losses=[float(x) for x in losses], events=events,
                test_psnr=None if ev is None else ev[0], initial=initial)


if __name__ == "__main__":
    main()
