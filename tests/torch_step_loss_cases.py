"""The ``train_colmap`` CLI's step loss in both packages (a helper
module for tests/test_torch_train_colmap_cli*.py, no tests)."""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mojosplat_tpu import (
    RenderConfig, apply_bilateral_grid, apply_pose_delta, bilateral_grid_tv, render_gaussians)
from mojosplat_tpu import train as mtrain
from mojosplat_tpu.densify import pad_to_capacity
from mojosplat_tpu.utils import colmap as jcm
from mojosplat_tpu_torch.examples import train_colmap
from mojosplat_tpu_torch.utils import colmap as cm


class StepLoss:
    """The ``train_colmap`` CLI's step loss on ``train_capture``'s files,
    in both packages: ``--strategy none --depth-loss --pose-opt
    --exposure-opt --bilagrid --intrinsics-opt`` on the port's ``"torch"``
    route and, composed from the JAX package as ``examples/train_colmap.py``'s
    ``loss_fn`` composes it, on JAX's ``"xla"`` route; the SSIM weight an
    argument. The view parameters at step 0 (``identity``) and a seeded
    state off identity (``moved``)."""

    FLAGS = ["--downscale", "1", "--device", "cpu", "--impl", "torch", "--sh-degree", "1",
             "--max-gaussians", "256", "--depth-loss", "0.05", "--pose-opt", "--exposure-opt",
             "--bilagrid", "--intrinsics-opt"]
    CAMERA_ARRAYS = ("R", "T", "fx", "fy", "cx", "cy", "near", "far", "dist", "rs_vel")

    def __init__(self, capture: Path):
        self.args = train_colmap.build_parser().parse_args(["--data", str(capture)] + self.FLAGS)
        self.config = train_colmap.render_config(self.args, surfels=False)
        sparse = str(capture / "sparse" / "0")
        self.scene, self.jscene = cm.load_scene(sparse, True), jcm.load_scene(sparse, True)
        self.views, self.images = train_colmap.load_view_images(str(capture), self.scene, 1)
        self.depth = cm.sparse_depth_targets(self.scene, self.views, 1)
        raw = cm.init_gaussians_from_points(self.scene.points_xyz, self.scene.points_rgb,
                                            sh_degree=1)
        self.raw = jax.tree_util.tree_map(np.asarray, pad_to_capacity(raw, 256))
        jcfg = RenderConfig(tile_capacity=512, chunk_size=64, max_tile_span=8, tile_batch=512,
                            raster_impl="xla", pallas_chunk=128, isect_padding_multiplier=4)
        args = self.args

        def loss_fn(params, v, i, cam, target, duv, dz, dm, ssim_weight):
            p = mtrain.activate(params)
            c = apply_pose_delta(cam, v["pose"][i])
            di = v["intr"][i]
            c = dataclasses.replace(c, fx=c.fx * jnp.exp(di[0]), fy=c.fy * jnp.exp(di[1]),
                                    cx=c.cx + di[2], cy=c.cy + di[3])
            img, dmap, raux = render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], c,
                sh_degree=1, config=jcfg, return_depth=True, return_aux=True)
            img = mtrain.apply_exposure(img, v["expo"][i])
            img = apply_bilateral_grid(img, v["bgrid"][i])
            loss = mtrain.dssim_l1_loss(img, target, ssim_weight=ssim_weight)
            loss = loss + args.bilagrid_tv * bilateral_grid_tv(v["bgrid"][i])
            alpha = 1.0 - raux.raster.final_transmittance
            return loss + args.depth_loss * mtrain.sparse_depth_loss(dmap, alpha, duv, dz, dm)

        self._jfn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
        rng = np.random.default_rng(0)
        V = len(self.views)
        self.identity = dict(
            pose=np.zeros((V, 6), np.float32),
            expo=np.tile(np.eye(3, 4, dtype=np.float32), (V, 1, 1)),
            intr=np.zeros((V, 4), np.float32),
            bgrid=np.broadcast_to(np.concatenate([np.eye(3).reshape(9), np.zeros(3)]),
                                  (V, 16, 16, 8, 12)).astype(np.float32),
        )
        self.moved = dict(
            pose=rng.normal(0, 2e-3, (V, 6)).astype(np.float32),
            expo=(self.identity["expo"] + rng.normal(0, 0.02, (V, 3, 4))).astype(np.float32),
            intr=rng.normal(0, [1e-3, 1e-3, 0.3, 0.3], (V, 4)).astype(np.float32),
            bgrid=(self.identity["bgrid"]
                   + rng.normal(0, 0.02, self.identity["bgrid"].shape)).astype(np.float32),
        )

    def port(self, vp_np, i: int, ssim_weight: float, dtype=None):
        """(loss, (d params, d view params)) of the port, numpy, in
        ``dtype`` (torch.float32 by default)."""
        dtype = dtype or torch.float32

        def leaf(a):
            return torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True)

        params = {k: leaf(v) for k, v in self.raw.items()}
        vp = {k: leaf(v) for k, v in vp_np.items()}
        cam = self.scene.camera_for(self.views[i], 1, device="cpu")
        cam = dataclasses.replace(cam, **{k: getattr(cam, k).to(dtype)
                                          for k in self.CAMERA_ARRAYS})
        targets = [torch.from_numpy(a[i]) for a in self.depth]
        targets = [t.to(dtype) if t.is_floating_point() else t for t in targets]
        args = argparse.Namespace(**dict(vars(self.args), ssim_weight=ssim_weight))
        loss, _ = train_colmap.step_loss(params, vp, i, cam,
                                         torch.from_numpy(self.images[i]).to(dtype), targets,
                                         args, self.config, 1)
        loss.backward()
        return (loss.detach().numpy(), ({k: t.grad.numpy() for k, t in params.items()},
                                        {k: t.grad.numpy() for k, t in vp.items()}))

    def jax(self, vp_np, i: int, ssim_weight: float, dtype=np.float32):
        """The same from the JAX package, numpy; ``dtype=np.float64`` runs
        under ``jax.enable_x64`` with every float input cast."""
        inputs = (self.raw, vp_np, i, self.jscene.camera_for(self.views[i], 1),
                  self.images[i], *(a[i] for a in self.depth), np.float64(ssim_weight))

        def cast(a):
            a = np.asarray(a)
            return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a

        with jax.enable_x64(dtype == np.float64):
            inputs = [x if isinstance(x, int) else jax.tree_util.tree_map(cast, x)
                      for x in inputs]
            return jax.tree_util.tree_map(np.asarray, self._jfn(*inputs))


def tree_leaves(*trees):
    """Zip the leaves of same-structured trees, with their paths."""
    return zip(*(jax.tree_util.tree_leaves_with_path(t) for t in trees))
