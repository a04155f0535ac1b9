"""The JAX package's single-device 2DGS loss on the sharded surfel world's
inputs (a helper module, no tests): tests/test_sharding.py's reference
(photometric, distortion at 0.01 and normal consistency at 0.05, summed
over two views at 128x64), with its gradient and the two views' images.

``reference(jit)`` evaluates it eagerly (what
scripts/make_sharded_surfel_golden.py writes to
tests/golden/sharded_surfel.npz) or under ``jax.jit``. Under jit, XLA on
the CPU rewrites the surfel alpha into other roundings: an alpha-threshold
flip moves a pixel, and the gradient of the gaussians under it moves with
it. tests/test_torch_sharding_surfel.py holds the port to both.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mojosplat_tpu import Camera, RenderConfig
from mojosplat_tpu import train as mtrain
from mojosplat_tpu.surfel import normal_consistency_terms, render_surfels
from torch_parallel_cases import CFG, SURFEL_H, SURFEL_WEIGHTS, cameras_np, surfel_targets_np
from torch_parallel_cases import surfels_np


def reference(jit: bool) -> dict:
    """``loss``, ``images`` (2, 128, 64, 3) and ``grad_<leaf>`` as numpy."""
    cfg = RenderConfig(**CFG)
    cams = [Camera.create(R=c["R"], T=c["T"], H=c["H"], W=c["W"], fx=c["fx"], fy=c["fy"],
                          cx=c["cx"], cy=c["cy"], near=c["near"], far=c["far"])
            for c in cameras_np(2, H=SURFEL_H, seed=0)]
    targets = jnp.asarray(surfel_targets_np())
    nw, dw = SURFEL_WEIGHTS["normal_weight"], SURFEL_WEIGHTS["distortion_weight"]

    def loss_fn(params):
        p = mtrain.activate(params)
        terms, imgs = [], []
        for i, cam in enumerate(cams):
            img, depth, normal, dist, aux = render_surfels(
                p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam,
                config=cfg, return_aux=True, return_depth=True, return_normals=True,
                return_distortion=True)
            num, den = normal_consistency_terms(depth, normal,
                                                aux.raster.final_transmittance, cam)
            terms.append((jnp.sum((img - targets[i]) ** 2), jnp.sum(dist), num, den))
            imgs.append(img)
        photo, dist, num, den = (sum(t[j] for t in terms) for j in range(4))
        loss = (photo / targets.size + dw * dist / (targets.size // 3)
                + nw * num / jnp.maximum(den, 1.0))
        return loss, jnp.stack(imgs)

    f = jax.value_and_grad(loss_fn, has_aux=True)
    (loss, imgs), grads = (jax.jit(f) if jit else f)(
        {k: jnp.asarray(v) for k, v in surfels_np(48, 21).items()})
    return dict(loss=np.asarray(loss), images=np.asarray(imgs),
                **{f"grad_{k}": np.asarray(v) for k, v in grads.items()})
