"""Train a 3DGS (or 2DGS) scene from a COLMAP capture.

Port of ``examples/train_colmap.py`` to PyTorch: parse a COLMAP sparse
model (native C readers), seed gaussians from the SfM point cloud, and
optimise them against the captured images with the D-SSIM + L1 loss,
optionally refining per-view poses, intrinsics, exposure affines and
bilateral grids, with sparse SfM depth supervision and ADC or MCMC density
control at a fixed capacity; checkpoint, resume, and write the PLY.

    python -m mojosplat_tpu_torch.examples.train_colmap --data /path/to/capture \\
        --downscale 4 --steps 2000

runs on the card through the CUDA kernels (``--device cuda --impl cuda``,
the defaults); ``--device cpu --impl torch`` runs on the CPU through the
plain PyTorch route. Expects the INRIA layout:
<data>/images/*.{png,jpg} and <data>/sparse/0/{cameras,images,points3D}.bin.

Where the reference draws from ``jax.random`` keys (the MCMC noise and
relocation, the ADC split offsets), the port draws from one seeded
``torch.Generator``, saved in the checkpoint; the views are drawn from
``np.random.default_rng(0)`` as in the reference, restarting at its first
draw on ``--resume`` as the reference does.
"""

from __future__ import annotations

import argparse
import builtins
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mojosplat_tpu_torch import (
    RenderConfig,
    apply_bilateral_grid,
    apply_pose_delta,
    bilateral_grid_tv,
    identity_bilateral_grid,
    render_gaussians,
    render_surfels,
)
from mojosplat_tpu_torch import densify
from mojosplat_tpu_torch import train as mtrain
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.parallel import init_multihost, is_primary
from mojosplat_tpu_torch.surfel import normal_consistency_loss
from mojosplat_tpu_torch.utils import colmap as cm
from mojosplat_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from mojosplat_tpu_torch.utils.image import save_png
from mojosplat_tpu_torch.utils.ply import save_gaussian_ply

# The seed of the generator behind every random draw of density control
# (the reference's PRNGKey(17)).
GENERATOR_SEED = 17


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="capture root (INRIA layout)")
    ap.add_argument("--sparse", default=None,
                    help="sparse model dir (default <data>/sparse/0)")
    ap.add_argument("--downscale", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    ap.add_argument("--impl", default="cuda", choices=["torch", "cuda"],
                    help="'cuda': the hand-written kernels (needs --device cuda); "
                    "'torch': the plain PyTorch route")
    ap.add_argument("--primitive", default="3dgs", choices=["3dgs", "2dgs"],
                    help="'2dgs' trains gaussian surfels (Huang et al.): (N,2) "
                    "tangent scales, ray/disk intersection, the paper's depth-"
                    "distortion and normal-consistency regularizers")
    ap.add_argument("--normal-weight", type=float, default=0.05,
                    help="2DGS normal-consistency regularizer weight")
    ap.add_argument("--distortion-weight", type=float, default=100.0,
                    help="2DGS depth-distortion regularizer weight")
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ssim-weight", type=float, default=0.2)
    ap.add_argument("--tile-capacity", type=int, default=512)
    ap.add_argument("--capacity-mult", type=int, default=4,
                    help="intersection capacity as a multiple of N")
    ap.add_argument("--tight-cull", action="store_true",
                    help="contribution-aware intersection culling (3DGS only)")
    ap.add_argument("--max-gaussians", type=int, default=0,
                    help="static capacity (0 = round points up to 64k)")
    ap.add_argument("--out-dir", default="output/train_colmap")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--strategy", default="none", choices=["none", "mcmc", "adc"],
                    help="density control at fixed capacity: 'mcmc' = 3DGS-MCMC "
                    "relocation + opacity-gated noise + L1 regularizers; 'adc' = "
                    "clone/split/prune from view-space positional gradients")
    ap.add_argument("--densify-every", type=int, default=100,
                    help="steps between density-control events")
    ap.add_argument("--densify-grad-threshold", type=float, default=2e-6,
                    help="ADC mean view-space gradient threshold")
    ap.add_argument("--absgrad", action="store_true",
                    help="ADC statistic = absolute per-tile view-space gradients "
                    "(AbsGS; use a 2-4x higher --densify-grad-threshold)")
    ap.add_argument("--opacity-reset-every", type=int, default=0,
                    help="periodic opacity reset under ADC (e.g. 3000)")
    ap.add_argument("--sh-warmup-every", type=int, default=0,
                    help="raise the active SH degree by one every N steps, from DC")
    ap.add_argument("--depth-loss", type=float, default=0.0,
                    help="weight of the sparse SfM depth supervision "
                    "(train.sparse_depth_loss)")
    ap.add_argument("--pose-opt", action="store_true",
                    help="refine per-view se(3) pose deltas (apply_pose_delta)")
    ap.add_argument("--pose-lr", type=float, default=1e-4)
    ap.add_argument("--exposure-opt", action="store_true",
                    help="per-view affine colour correction (train.apply_exposure)")
    ap.add_argument("--exposure-lr", type=float, default=1e-3)
    ap.add_argument("--bilagrid", action="store_true",
                    help="per-view (16,16,8) bilateral-grid colour correction "
                    "(bilagrid.apply_bilateral_grid)")
    ap.add_argument("--bilagrid-lr", type=float, default=2e-3)
    ap.add_argument("--bilagrid-tv", type=float, default=10.0,
                    help="total-variation weight keeping each view's grid smooth")
    ap.add_argument("--intrinsics-opt", action="store_true",
                    help="refine per-view (log fx, log fy, cx, cy) deltas")
    ap.add_argument("--intrinsics-lr", type=float, default=1e-4)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the training state every N steps")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out-dir>/ckpt if present")
    ap.add_argument("--multihost", action="store_true",
                    help="start torch.distributed first (launch this CLI once per rank, "
                    "under torchrun or with MOJOSPLAT_COORDINATOR/_NUM_PROCESSES/"
                    "_PROCESS_ID); each rank trains its own replica on its own device "
                    "and only rank 0 prints and writes files")
    return ap


def resolve_device(name: str, impl: str) -> torch.device:
    """The device to train on. Raises where the card is asked for (the
    default) and there is none, and where the kernels are asked for off the
    card: the CLI never moves to the CPU or the plain route by itself."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is False "
                         "(pass --device cpu --impl torch to run on the CPU)")
    if impl == "cuda" and dev.type != "cuda":
        raise SystemExit(f"--impl cuda runs the CUDA kernels and needs a CUDA device, "
                         f"got --device {name} (use --impl torch on the CPU)")
    return dev


def load_view_images(data_dir: str, scene, downscale: int):
    """Every registered view's image, downscaled (LANCZOS), as float32 in
    [0, 1], read with PIL."""
    from PIL import Image

    images_dir = os.path.join(data_dir, "images")
    out, views = [], []
    for im in scene.images:
        path = os.path.join(images_dir, im.name)
        if not os.path.exists(path):
            print(f"  skipping {im.name}: file not found")
            continue
        img = Image.open(path).convert("RGB")
        if downscale > 1:
            img = img.resize((img.width // downscale, img.height // downscale), Image.LANCZOS)
        out.append(np.asarray(img, np.float32) / 255.0)
        views.append(im)
    return views, out


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def render_config(args, surfels: bool) -> RenderConfig:
    return RenderConfig(
        tile_capacity=args.tile_capacity, chunk_size=64, max_tile_span=8, tile_batch=512,
        raster_impl=args.impl, pallas_chunk=128, isect_padding_multiplier=args.capacity_mult,
        tight_cull=args.tight_cull and not surfels,
    )


def posed_camera(cam, view_params: dict, i: int, args):
    """View ``i``'s camera with its pose delta and intrinsics deltas, where
    those are refined; ``fx``/``cx`` keep their graph to the deltas."""
    c = apply_pose_delta(cam, view_params["pose"][i]) if args.pose_opt else cam
    if args.intrinsics_opt:
        di = view_params["intr"][i]
        c = dataclasses.replace(c, fx=c.fx * torch.exp(di[0]), fy=c.fy * torch.exp(di[1]),
                                cx=c.cx + di[2], cy=c.cy + di[3])
    return c


def step_loss(params: dict, view_params: dict, i: int, cam, target, depth_targets, args,
              config: RenderConfig, sh_degree: int, sink=None):
    """The training loss of view ``i`` (``examples/train_colmap.py``'s
    ``loss_fn``): D-SSIM + L1 of the render, after the view's exposure
    affine and bilateral grid where enabled, plus the grid's TV, the sparse
    depth loss, the 2DGS regularizers and the MCMC regularizer, as the
    flags in ``args`` (from ``build_parser``) say.

    ``params`` are the raw parameters, ``view_params`` the per-view dict
    (``pose``, ``expo``, ``intr`` and, with ``--bilagrid``, ``bgrid``),
    ``depth_targets`` the view's (uv, depth, mask) or None, ``sink`` the
    (N, 2) zero tensor whose gradient is ADC's statistic. Returns (loss,
    the render's ``RenderAux``)."""
    p = mtrain.activate(params)
    c = posed_camera(cam, view_params, i, args)
    splats = (p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], c)
    surfels = args.primitive == "2dgs"
    dmap = None
    if surfels:
        img, dmap, nmap, dist, aux = render_surfels(
            *splats, sh_degree=sh_degree, config=config, return_depth=True,
            return_normals=True, return_distortion=True, return_aux=True)
    else:
        kw = {}
        if sink is not None:
            kw = {"absgrad_sink" if args.absgrad else "means2d_offset": sink}
        out = render_gaussians(*splats, sh_degree=sh_degree, config=config,
                               return_depth=depth_targets is not None, return_aux=True, **kw)
        img, aux = out[0], out[-1]
        if depth_targets is not None:
            dmap = out[1]
    if args.exposure_opt:
        img = mtrain.apply_exposure(img, view_params["expo"][i])
    if args.bilagrid:
        img = apply_bilateral_grid(img, view_params["bgrid"][i])
    loss = mtrain.dssim_l1_loss(img, target, ssim_weight=args.ssim_weight)
    if args.bilagrid:
        # This view's grid only: the other views' rows keep an exactly-zero
        # gradient, so selective Adam leaves them frozen.
        loss = loss + args.bilagrid_tv * bilateral_grid_tv(view_params["bgrid"][i])
    if depth_targets is not None:
        alpha = 1.0 - aux.raster.final_transmittance
        loss = loss + args.depth_loss * mtrain.sparse_depth_loss(dmap, alpha, *depth_targets)
    if surfels:
        if args.distortion_weight:
            loss = loss + args.distortion_weight * torch.mean(dist)
        if args.normal_weight:
            loss = loss + args.normal_weight * normal_consistency_loss(
                dmap, nmap, aux.raster.final_transmittance, c)
    if args.strategy == "mcmc":
        loss = loss + densify.mcmc_regularization(params)
    return loss, aux


def _leaves(params: dict) -> dict:
    """Fresh leaf tensors (requires_grad) holding ``params``' values."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _view_optimizer(view_params: dict, lrs: dict) -> mtrain.selective_adam:
    """One selective Adam, a param group per view-parameter key with its
    own learning rate (the reference's multi_transform)."""
    return mtrain.selective_adam([{"params": [view_params[k]], "lr": lrs[k]}
                                  for k in view_params])


def training_state(step: int, params: dict, optimizer, view_params: dict, view_opt,
                   dstate, generator: torch.Generator) -> dict:
    """The checkpoint bundle: the raw parameters, the Adam state, the view
    parameters and their optimizer's state, ADC's statistics (under
    ``--strategy adc``), the step and the generator's state."""
    state = dict(
        step=step,
        params={k: v.detach() for k, v in params.items()},
        adam=optimizer.state_dict(),
        view_params={k: v.detach() for k, v in view_params.items()},
        view_adam=view_opt.state_dict(),
        generator=generator.get_state(),
    )
    if dstate is not None:
        state["dstate"] = dstate._asdict()
    return state


def _quiet(*args, **kwargs) -> None:
    """The print of a rank other than the primary."""


def main(argv=None, on_step=None) -> dict:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None). ``on_step(step,
    loss)`` is called after every step. Returns the run's losses (floats),
    the density events' metrics, and the final ``training_state``."""
    args = build_parser().parse_args(argv)
    # First: NCCL on this rank's card, or gloo when the CPU is asked for.
    multi = init_multihost(require=args.multihost,
                           backend="gloo" if args.device == "cpu" else None)
    try:
        return _train(args, on_step)
    finally:
        if multi:
            dist.destroy_process_group()


def _train(args, on_step) -> dict:
    # Every rank trains; only the primary prints and writes into out_dir
    # (the others would race it on the checkpoint, the PLYs and the PNGs).
    primary = is_primary()
    print = builtins.print if primary else _quiet  # noqa: A001
    dev = resolve_device(args.device, args.impl)
    # Full f32 for the SSIM blurs and every matmul (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if primary:
        os.makedirs(args.out_dir, exist_ok=True)

    sparse = args.sparse or os.path.join(args.data, "sparse", "0")
    print(f"Loading COLMAP model from {sparse}")
    scene = cm.load_scene(sparse, with_points2d=args.depth_loss > 0)
    print(f"  {len(scene.cameras)} cameras, {len(scene.images)} images, "
          f"{scene.points_xyz.shape[0]} points")

    views, images = load_view_images(args.data, scene, args.downscale)
    if not views:
        raise SystemExit("no images found")
    H, W = images[0].shape[:2]
    if any(im.shape[:2] != (H, W) for im in images):
        raise SystemExit("mixed image sizes are not supported (one camera assumed)")
    targets = torch.from_numpy(np.stack(images)).to(dev)
    cameras = [scene.camera_for(v, args.downscale, device=dev) for v in views]
    n_views = len(views)
    print(f"  {n_views} views at {W}x{H}")

    depth_sup = args.depth_loss > 0
    depth_targets = None
    if depth_sup:
        uv_np, dz_np, dm_np = cm.sparse_depth_targets(scene, views, args.downscale)
        depth_targets = [torch.from_numpy(a).to(dev) for a in (uv_np, dz_np, dm_np)]
        print(f"  depth supervision: {int(dm_np.sum())} SfM targets "
              f"({dm_np.shape[1]} slots/view)")

    t0 = time.perf_counter()
    raw_np = cm.init_gaussians_from_points(scene.points_xyz, scene.points_rgb,
                                           sh_degree=args.sh_degree)
    print(f"  initialized {scene.points_xyz.shape[0]} gaussians from the SfM points "
          f"in {time.perf_counter() - t0:.3f} s")
    surfels = args.primitive == "2dgs"
    if surfels:
        raw_np["scales"] = raw_np["scales"][:, :2]  # (N, 2) tangent-plane log scales
    n_pts = scene.points_xyz.shape[0]
    cap = args.max_gaussians or round_up(max(n_pts, 1), 65536)
    raw = params_from_numpy(raw_np, dev)
    if cap > n_pts:
        raw = densify.pad_to_capacity(raw, cap)
        print(f"  padded {n_pts} -> {cap} gaussian slots")
    params = _leaves(raw)
    config = render_config(args, surfels)
    optimizer = mtrain.make_optimizer(params, args.lr)
    generator = torch.Generator(device=dev)
    generator.manual_seed(GENERATOR_SEED)

    mcmc = args.strategy == "mcmc"
    adc = args.strategy == "adc"
    if adc and surfels:
        raise SystemExit("--strategy adc needs the 3DGS view-space gradient sink; "
                         "use --strategy mcmc with --primitive 2dgs")
    dstate = None
    if adc:
        # The split/clone size scale: the radius of the camera rig.
        R = np.stack([c.R.cpu().numpy() for c in cameras])
        T = np.stack([c.T.cpu().numpy() for c in cameras])
        centers = -np.einsum("vji,vj->vi", R, T)
        extent = float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0), axis=-1))) or 1.0
        print(f"  ADC scene extent {extent:.3f}")
        dcfg = densify.DensifyConfig(grad_threshold=args.densify_grad_threshold)
        dstate = densify.DensifyState.zero(cap, dev)

    # Per-view nuisance parameters, stepped by selective Adam: only the view
    # rendered this step has a nonzero gradient row, and a disabled group
    # gets no gradient at all, so it stays exactly at identity.
    view_params = {
        "pose": torch.zeros((n_views, 6), device=dev),
        "expo": mtrain.identity_exposure(n_views, device=dev),
        "intr": torch.zeros((n_views, 4), device=dev),
    }
    view_lrs = {"pose": args.pose_lr, "expo": args.exposure_lr, "intr": args.intrinsics_lr}
    if args.bilagrid:
        view_params["bgrid"] = identity_bilateral_grid(n_views, device=dev)
        view_lrs["bgrid"] = args.bilagrid_lr
    view_params = _leaves(view_params)
    view_opt = _view_optimizer(view_params, view_lrs)
    view_opt_on = args.pose_opt or args.exposure_opt or args.intrinsics_opt or args.bilagrid

    ckpt_path = os.path.join(os.path.abspath(args.out_dir), "ckpt")
    start_step = 0
    if args.resume and os.path.exists(ckpt_path):
        bundle = restore_checkpoint(ckpt_path, dev)
        if set(bundle["view_params"]) != set(view_params):
            raise SystemExit(
                f"checkpoint restore failed: it holds the view parameters "
                f"{sorted(bundle['view_params'])}, these flags make {sorted(view_params)} "
                "(was --bilagrid switched since it was written?); restart without "
                "--resume or with the original flags")
        params = _leaves(bundle["params"])
        optimizer = mtrain.make_optimizer(params, args.lr)
        optimizer.load_state_dict(bundle["adam"])
        view_params = _leaves(bundle["view_params"])
        view_opt = _view_optimizer(view_params, view_lrs)
        view_opt.load_state_dict(bundle["view_adam"])
        if dstate is not None:
            if "dstate" in bundle:
                dstate = densify.DensifyState(**bundle["dstate"])
            else:
                print("  note: checkpoint has no densify stats; "
                      "accumulation window restarts at zero")
        generator.set_state(bundle["generator"].cpu())
        start_step = int(bundle["step"])
        print(f"  resumed from {ckpt_path} at step {start_step}")

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    losses, events = [], []
    for step in range(start_step, args.steps):
        i = int(rng.integers(n_views))
        active_sh = (min(args.sh_degree, step // args.sh_warmup_every)
                     if args.sh_warmup_every else args.sh_degree)
        optimizer.zero_grad(set_to_none=True)
        view_opt.zero_grad(set_to_none=True)
        sink = torch.zeros((cap, 2), device=dev, requires_grad=True) if adc else None
        depth_i = None if depth_targets is None else [t[i] for t in depth_targets]
        loss, aux = step_loss(params, view_params, i, cameras[i], targets[i], depth_i, args,
                              config, active_sh, sink)
        loss.backward()
        if adc:
            # The projection's radii test of the render just made (the
            # reference re-projects the same parameters and camera).
            dstate = densify.accumulate_stats(dstate, sink.grad, aux.visible)
        optimizer.step()
        if view_opt_on:
            view_opt.step()
        if mcmc:
            with torch.no_grad():
                noisy = densify.mcmc_position_noise(params, generator, args.lr)
                params["means3d"].copy_(noisy["means3d"])
        losses.append(loss.detach())

        last = step + 1 >= args.steps
        if adc and (step + 1) % args.densify_every == 0 and not last:
            new, dstate, m = densify.densify_and_prune(params, dstate, generator, extent, dcfg)
            params = _leaves(new)
            optimizer = mtrain.make_optimizer(params, args.lr)  # fresh Adam state
            m = {k: int(v) for k, v in m.items()}
            events.append(dict(step=step + 1, kind="densify", **m))
            print(f"  [densify: +{m['cloned']} cloned, +{m['split']} split, "
                  f"-{m['pruned']} pruned, {m['alive']} alive]", flush=True)
        if adc and args.opacity_reset_every and (step + 1) % args.opacity_reset_every == 0 \
                and not last:
            params = _leaves(densify.reset_opacities(params))
            optimizer = mtrain.make_optimizer(params, args.lr)
            events.append(dict(step=step + 1, kind="opacity_reset"))
            print("  [opacity reset]", flush=True)
        if mcmc and (step + 1) % args.densify_every == 0 and not last:
            new, m = densify.mcmc_relocate(params, generator)
            params = _leaves(new)
            optimizer = mtrain.make_optimizer(params, args.lr)
            m = {k: int(v) for k, v in m.items()}
            events.append(dict(step=step + 1, kind="mcmc", **m))
            print(f"  [mcmc: {m['relocated']} relocated, {m['alive']} alive]", flush=True)
        if (step + 1) % 50 == 0:
            lv = float(torch.stack(losses[-50:]).mean())
            print(f"step {step + 1:5d}  loss {lv:.5f}  "
                  f"{(step + 1 - start_step) / (time.perf_counter() - t0):.2f} steps/s",
                  flush=True)
        if primary and args.save_every and (step + 1) % args.save_every == 0:
            ply = os.path.join(args.out_dir, f"scene_{step + 1:06d}.ply")
            save_gaussian_ply(ply, params)
            print(f"  saved {ply}")
        if primary and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(ckpt_path, training_state(step + 1, params, optimizer, view_params,
                                                      view_opt, dstate, generator))
            print(f"  checkpointed step {step + 1} -> {ckpt_path}")
        if on_step is not None:
            on_step(step, loss)

    result = dict(
        losses=[float(x) for x in losses], events=events,
        state=training_state(args.steps, params, optimizer, view_params, view_opt, dstate,
                             generator),
    )
    if not primary:
        return result
    save_gaussian_ply(os.path.join(args.out_dir, "scene_final.ply"), params)
    vp = {k: v.detach() for k, v in view_params.items()}
    if args.pose_opt:
        d = vp["pose"].cpu().numpy()
        rot_deg = np.degrees(np.linalg.norm(d[:, :3], axis=-1))
        trans = np.linalg.norm(d[:, 3:], axis=-1)
        print(f"pose refinement: mean correction {rot_deg.mean():.4f} deg / "
              f"{trans.mean():.5f} units (max {rot_deg.max():.4f} deg / {trans.max():.5f})")
        np.save(os.path.join(args.out_dir, "pose_deltas.npy"), d)
    if args.exposure_opt:
        e = vp["expo"].cpu().numpy()
        dev_e = np.abs(e - mtrain.identity_exposure(n_views, device="cpu").numpy())
        print(f"exposure refinement: mean |affine - identity| {dev_e.mean():.5f} "
              f"(max {dev_e.max():.5f})")
        np.save(os.path.join(args.out_dir, "exposure_affines.npy"), e)
    if args.bilagrid:
        g = vp["bgrid"].cpu().numpy()
        dev_g = np.abs(g - identity_bilateral_grid(n_views, device="cpu").numpy())
        print(f"bilateral grids: mean |grid - identity| {dev_g.mean():.5f} "
              f"(max {dev_g.max():.5f})")
        np.save(os.path.join(args.out_dir, "bilateral_grids.npy"), g)
    if args.intrinsics_opt:
        di = vp["intr"].cpu().numpy()
        print(f"intrinsics refinement: mean |dlog f| {np.abs(di[:, :2]).mean():.5f}, "
              f"mean |dc| {np.abs(di[:, 2:]).mean():.4f} px")
        np.save(os.path.join(args.out_dir, "intrinsics_deltas.npy"), di)
    with torch.no_grad():
        p = mtrain.activate(params)
        render = render_surfels if surfels else render_gaussians
        img = render(p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"],
                     posed_camera(cameras[0], vp, 0, args), sh_degree=args.sh_degree,
                     config=config)
    save_png(img.cpu().numpy(), os.path.join(args.out_dir, "render_view0.png"))
    save_png(targets[0].cpu().numpy(), os.path.join(args.out_dir, "target_view0.png"))
    print(f"Done: artifacts in {args.out_dir}")
    return result


if __name__ == "__main__":
    main()
