"""PyTorch port: ``ops.rasterization.rasterize_dense_oracle``.

The port's oracle against the reference's on tests/test_rasterization.py's
oracle inputs (48x80, 80 gaussians, seed 7, projected by the reference)
within 1e-5; and the port's routes against the port's oracle at 1e-4, as
the reference test holds its tiled route to its oracle. The reference's
oracle is compiled once for the module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu.ops.rasterization import rasterize_dense_oracle as joracle
from mojosplat_tpu_torch import Camera, RenderConfig
from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
from mojosplat_tpu_torch.ops.projection import project_gaussians
from mojosplat_tpu_torch.ops.rasterization import rasterize_dense_oracle, rasterize_gaussians
from test_rasterization import CFG as JCFG
from test_rasterization import make_camera, make_scene, project_and_bin

H, W, N, SEED = 48, 80, 80, 7
BG = (0.1, 0.2, 0.3)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def case():
    """The reference test's scene, its projection and its oracle image."""
    cam = make_camera(H=H, W=W)
    scene = [np.asarray(a) for a in make_scene(N, seed=SEED)]
    proj, _ = project_and_bin(*map(jnp.asarray, scene[:4]), cam)
    _, _, _, opac, colors = scene
    bg = jnp.asarray(BG, jnp.float32)
    want = np.asarray(joracle(proj.means2d, proj.conics, jnp.asarray(colors),
                              jnp.asarray(opac), bg, proj.depths, proj.radii, H, W, JCFG))
    proj_np = {k: np.asarray(getattr(proj, k)) for k in ("means2d", "conics", "depths", "radii")}
    return dict(scene=scene, proj=proj_np, want=want)


def port_config(impl="torch"):
    return RenderConfig(tile_capacity=JCFG.tile_capacity, chunk_size=JCFG.chunk_size,
                        raster_impl=impl)


def test_oracle_matches_reference(case):
    p = case["proj"]
    _, _, _, opac, colors = case["scene"]
    got = rasterize_dense_oracle(t(p["means2d"]), t(p["conics"]), t(colors), t(opac),
                                 torch.tensor(BG), t(p["depths"]), t(p["radii"]), H, W,
                                 port_config())
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), case["want"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_routes_match_port_oracle(case, impl):
    """The tiled route (on the CPU the "cuda" route runs the kernels' plain
    versions) against the port's oracle, both from the port's projection."""
    means, log_scales, quats, opac, colors = map(t, case["scene"])
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=100.0, fy=100.0, cx=W / 2,
                        cy=H / 2, device="cpu")
    cfg = port_config(impl)
    proj = project_gaussians(means, log_scales, quats, opac, cam, cfg)
    binning = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, H, W, cfg)
    bg = torch.tensor(BG)
    img, aux = rasterize_gaussians(proj.means2d, proj.conics, colors, opac, bg, binning, H, W,
                                   cfg)
    assert int(aux.tile_overflow) == 0
    oracle = rasterize_dense_oracle(proj.means2d, proj.conics, colors, opac, bg, proj.depths,
                                    proj.radii, H, W, cfg)
    np.testing.assert_allclose(img.numpy(), oracle.numpy(), atol=1e-4, rtol=1e-4)
