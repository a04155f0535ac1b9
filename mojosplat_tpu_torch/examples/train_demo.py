"""End-to-end training demo: fit a gaussian cloud to rendered target views.

Port of ``examples/train_demo.py``: a ground-truth scene renders B target
views, a fresh random cloud is optimised with Adam through the renderer
(the L2 loss averaged over the views, ``train.train_step``), optionally
with ADC or MCMC density control, and the fitted scene is exported as a
3DGS PLY plus before/after PNGs.

    python -m mojosplat_tpu_torch.examples.train_demo --steps 300

runs on the card through the CUDA kernels (``--device cuda --impl cuda``,
the defaults); ``--device cpu --impl torch`` on the CPU.

The reference vmaps over the views and runs ``--steps-per-call`` steps in
one ``lax.scan``. Here the views render one after another inside each
step, every step is its own call, and ``--steps-per-call`` keeps the role
it has outside the scan: the cadence of the loss lines. Density events
fall on every ``--densify-every``-th step before the last (the reference
checks at the end of each scan, which is the same step when
``--densify-every`` is a multiple of ``--steps-per-call``, as at the
defaults). The run takes exactly ``--steps`` steps (the reference rounds
up to whole scans). The clouds and every draw of density control come from
``torch.Generator``s seeded as the reference's keys (0, 42 and 7); the
numbers differ from the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_gaussians
from mojosplat_tpu_torch import densify
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.examples.train_colmap import _leaves, resolve_device
from mojosplat_tpu_torch.utils import save_gaussian_ply, save_png

GT_SEED, FIT_SEED, DENSIFY_SEED = 0, 42, 7
SCENE_EXTENT = 3.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-gaussians", type=int, default=4000)
    ap.add_argument("--fit-gaussians", type=int, default=4000)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels; 'torch': the plain route")
    ap.add_argument("--out-dir", default="output/train_demo")
    ap.add_argument("--steps-per-call", type=int, default=25,
                    help="steps between two loss lines")
    ap.add_argument("--densify-every", type=int, default=0,
                    help="run adaptive density control every N steps (0 = off); starts "
                    "from fit-gaussians live slots padded to 2x capacity")
    ap.add_argument("--densify-grad-threshold", type=float, default=2e-6,
                    help="mean view-space gradient norm above which a gaussian is "
                    "cloned/split (the INRIA 2e-4 default assumes their loss scale; "
                    "this demo's plain L2 on small images runs ~100x lower)")
    ap.add_argument("--strategy", default="adc", choices=["adc", "mcmc"],
                    help="density-control family when --densify-every > 0: 'adc' = "
                    "INRIA clone/split/prune; 'mcmc' = 3DGS-MCMC relocation + "
                    "opacity-gated position noise + L1 regularizers")
    return ap


def make_cameras(B: int, H: int, W: int, *, device) -> list[Camera]:
    """B cameras on a ring of radius 4 at height 1 looking at the origin,
    focal 0.7 W."""
    f = 0.7 * W
    cams = []
    for i in range(B):
        ang = 2.0 * math.pi * i / B
        R, T = look_at(eye=[4.0 * math.sin(ang), 1.0, 4.0 * math.cos(ang)],
                       target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0], device=device)
        cams.append(Camera.create(R=R, T=T, H=H, W=W, fx=f, fy=f, cx=W / 2, cy=H / 2,
                                  near=0.1, far=100.0, device=device))
    return cams


def demo_config(impl: str) -> RenderConfig:
    return RenderConfig(tile_capacity=256, chunk_size=64, max_tile_span=8, raster_impl=impl,
                        pallas_chunk=128)


def render_batch(p: dict, cams, config: RenderConfig) -> torch.Tensor:
    with torch.no_grad():
        return torch.stack([
            render_gaussians(p["means3d"], p["scales"], p["quats"], p["opacities"],
                             p["features"], cam, config=config) for cam in cams])


def random_cloud(n: int, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return mtrain.init_gaussians(n, position_scale=1.2, log_scale_mean=-2.6, generator=gen,
                                 device=device)


def main(argv=None, on_step=None) -> dict:
    """Run the demo on ``argv``; ``on_step(step, loss)`` is called after
    every step. Returns the initial and final PSNR, the losses (floats) and
    the density events' metrics."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, args.impl)
    os.makedirs(args.out_dir, exist_ok=True)
    config = demo_config(args.impl)
    H, W, B = args.height, args.width, args.views
    cams = make_cameras(B, H, W, device=dev)

    # Ground-truth scene and target views.
    gt = mtrain.activate(random_cloud(args.gt_gaussians, GT_SEED, dev))
    targets = render_batch(gt, cams, config)
    print(f"Rendered {B} target views at {W}x{H}")

    # Fresh cloud to optimize.
    raw = random_cloud(args.fit_gaussians, FIT_SEED, dev)
    dens = args.densify_every > 0
    adc = dens and args.strategy == "adc"
    mcmc = dens and args.strategy == "mcmc"
    if dens:
        raw = densify.pad_to_capacity(raw, 2 * args.fit_gaussians)
    params = _leaves(raw)
    optimizer = mtrain.make_optimizer(params, args.lr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(DENSIFY_SEED)
    if adc:
        dstate = densify.DensifyState.zero(raw["opacities_raw"].shape[0], dev)
        dcfg = densify.DensifyConfig(grad_threshold=args.densify_grad_threshold)

    img0 = render_batch(mtrain.activate(params), cams, config)
    psnr0 = float(mtrain.psnr(img0, targets))
    print(f"initial PSNR: {psnr0:.2f} dB")
    save_png(img0[0].cpu().numpy(), os.path.join(args.out_dir, "before.png"))
    save_png(targets[0].cpu().numpy(), os.path.join(args.out_dir, "target.png"))

    t0 = time.perf_counter()
    losses, events = [], []
    for step in range(args.steps):
        if adc:
            dstate, loss = mtrain.train_step_with_densify_stats(params, optimizer, dstate, cams,
                                                                targets, config=config)
        elif mcmc:
            loss = mtrain.train_step(params, optimizer, cams, targets, config=config,
                                     loss_extra=densify.mcmc_regularization)
            with torch.no_grad():
                noisy = densify.mcmc_position_noise(params, gen, args.lr)
                params["means3d"].copy_(noisy["means3d"])
        else:
            loss = mtrain.train_step(params, optimizer, cams, targets, config=config)
        losses.append(loss)
        done = step + 1
        msg = None
        if done % args.steps_per_call == 0 or done == args.steps:
            msg = (f"step {done:5d}  loss {float(loss):.6f}  "
                   f"({(time.perf_counter() - t0) / done * 1000:.1f} ms/step avg)")
        if dens and done % args.densify_every == 0 and done < args.steps:
            if adc:
                new, dstate, m = densify.densify_and_prune(params, dstate, gen, SCENE_EXTENT,
                                                           dcfg)
                m = {k: int(v) for k, v in m.items()}
                note = (f"  [densify: +{m['cloned']} cloned, +{m['split']} split, "
                        f"-{m['pruned']} pruned, {m['alive']} alive]")
            else:
                new, m = densify.mcmc_relocate(params, gen)
                m = {k: int(v) for k, v in m.items()}
                note = f"  [mcmc: {m['relocated']} relocated, {m['alive']} alive]"
            # Fresh optimizer state for the mutated parameter set.
            params = _leaves(new)
            optimizer = mtrain.make_optimizer(params, args.lr)
            events.append(dict(step=done, **m))
            msg = (msg or f"step {done:5d}") + note
        if msg:
            print(msg, flush=True)
        if on_step is not None:
            on_step(step, loss)

    imgN = render_batch(mtrain.activate(params), cams, config)
    final_psnr = float(mtrain.psnr(imgN, targets))
    print(f"final PSNR: {final_psnr:.2f} dB after {args.steps} steps")
    save_png(imgN[0].cpu().numpy(), os.path.join(args.out_dir, "after.png"))
    ply_path = os.path.join(args.out_dir, "fitted.ply")
    save_gaussian_ply(ply_path, params)
    print(f"Saved fitted scene to {ply_path}")
    return dict(initial_psnr=psnr0, final_psnr=final_psnr,
                losses=[float(x) for x in losses], events=events)


if __name__ == "__main__":
    main()
