"""PyTorch port: tight culling (``tight_cull``) against the JAX package.

(a) Binning with ``tight_cull`` on: both port routes ("torch", and "cuda"
    with B4's plain version on CPU tensors) bit-equal to both JAX routes
    ("xla", and "pallas" in interpret mode): ids, tile ids, ranges and
    every ``BinningAux`` counter, ``tight_culled`` included. Scenes as in
    tests/test_tight_cull.py: anisotropic splats, opacities near the
    threshold; span 8 (three mask rows) under capacity overflow, and
    preset 6's span 4 at tile size 32.
(b) ``render_gaussians`` with ``tight_cull`` at the golden size on both
    port routes against the JAX render: image within 1e-5, counters equal,
    every parameter's gradient at the golden tolerance (rtol 5e-5, atol
    5e-6 x max|g|).
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import render_gaussians as jrender
from mojosplat_tpu.ops.binning import _decode_mask_tile as jdecode
from mojosplat_tpu.ops.binning import bin_gaussians_to_tiles as jbin
from mojosplat_tpu.ops.projection import project_gaussians as jproject
from mojosplat_tpu_torch import Camera, config_from_jax, render_gaussians
from mojosplat_tpu_torch.convert import params_from_numpy
from mojosplat_tpu_torch.ops import binning as tbin

ROOT = Path(__file__).resolve().parent.parent
H, W = 96, 128
RTOL, ATOL = 5e-5, 5e-6
KEYS = ("means3d", "scales", "quats", "opacities", "features")


def aniso_scene(n, seed):
    """Gaussians in front of the camera, one long and one short axis (the
    anisotropic splats whose AABB holds empty tiles), a few opacities on
    either side of the blend threshold."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 1.0, (n, 2)), rng.uniform(1.5, 5.0, (n, 1))], 1)
    scales = np.stack([rng.normal(-1.0, 0.3, n), rng.normal(-3.5, 0.3, n),
                       rng.normal(-2.0, 0.1, n)], axis=1)
    opac = rng.uniform(0.02, 0.95, n)
    opac[:6] = 1.0 / 255.0 * np.array([0.9, 0.999, 1.0, 1.001, 1.1, 2.0])
    f32 = np.float32
    return dict(means3d=means.astype(f32), scales=scales.astype(f32),
                quats=rng.normal(size=(n, 4)).astype(f32), opacities=opac.astype(f32),
                features=rng.uniform(0, 1, (n, 3)).astype(f32))


def jax_camera(h=H, w=W):
    return JCamera.create(R=np.eye(3), T=np.zeros(3), H=h, W=w, fx=90.0, fy=90.0,
                          cx=w / 2, cy=h / 2)


CASES = {
    # span 8: 64 candidate bits in three mask rows; the capacity overflows
    "span8_overflow": (dict(max_tile_span=8), 1024, 300),
    "span4_ts32": (dict(max_tile_span=4, tile_size=32), None, 300),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tight_binning_routes_match_jax(case):
    cfg_kw, capacity, n = CASES[case]
    p = aniso_scene(n, seed=len(case))
    base = JConfig(tight_cull=True, isect_padding_multiplier=8, **cfg_kw)
    proj = jproject(*(jnp.asarray(p[k]) for k in KEYS[:4]), jax_camera(), base)
    arrays = [np.array(x) for x in (proj.means2d, proj.radii, proj.depths, proj.conics)]
    arrays.append(p["opacities"])
    want = {}
    for impl in ("xla", "pallas"):
        jcfg = dataclasses.replace(base, raster_impl=impl, pallas_interpret=True)
        fn = functools.partial(jbin, img_height=H, img_width=W, config=jcfg, capacity=capacity)
        if base.max_tile_span <= 4:  # compiling 64 unrolled candidates takes longer than eager
            fn = jax.jit(fn)
        m2, r, d, c, o = (jnp.asarray(a) for a in arrays)
        want[impl] = fn(m2, r, d, conics=c, opacities=o)
    t = [torch.from_numpy(a) for a in arrays]
    for impl in ("xla", "pallas"):
        cfg = config_from_jax(dataclasses.asdict(dataclasses.replace(base, raster_impl=impl)))
        got = tbin.bin_gaussians_to_tiles(t[0], t[1], t[2], H, W, cfg, capacity=capacity,
                                          conics=t[3], opacities=t[4])
        for name in ("gaussian_ids", "tile_ids", "tile_ranges"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want[impl], name)),
                                          err_msg=f"{impl}: {name}")
        for name, value in got.aux._asdict().items():
            assert int(value) == int(getattr(want[impl].aux, name)), (impl, name)
    aux = want["xla"].aux
    assert int(aux.tight_culled) > 0, "the anisotropic scene must cull some AABB slots"
    if capacity is not None:
        assert int(aux.capacity_overflow) > 0 and int(aux.num_isects) == capacity
    # Without conics tight_cull changes nothing (the surfel binning).
    cfg = config_from_jax(dataclasses.asdict(base))
    plain = tbin.bin_gaussians_to_tiles(t[0], t[1], t[2], H, W, cfg, capacity=capacity)
    off = tbin.bin_gaussians_to_tiles(t[0], t[1], t[2], H, W,
                                      dataclasses.replace(cfg, tight_cull=False),
                                      capacity=capacity)
    assert torch.equal(plain.gaussian_ids, off.gaussian_ids)
    assert int(plain.aux.tight_culled) == 0


@pytest.mark.parametrize("span", [2, 4, 8])
def test_decode_matches_jax(span):
    """The port's word-lookup decode against the reference's bit walk, on
    random masks (22 bits a row) and every k below each mask's count."""
    rng = np.random.default_rng(span)
    n_bits, tw = span * span, 37
    bits = rng.random((500, n_bits)) < rng.uniform(0.05, 0.95, (500, 1))
    rows = [np.zeros(500, np.int32) for _ in range(-(-n_bits // tbin._MASK_BITS))]
    for j in range(n_bits):
        rows[j // tbin._MASK_BITS] |= bits[:, j].astype(np.int32) << (j % tbin._MASK_BITS)
    counts = bits.sum(1)
    owner = np.repeat(np.arange(500), counts)
    k = (np.arange(owner.size) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    tx, ty = rng.integers(0, 30, 500).astype(np.int32), rng.integers(0, 20, 500).astype(np.int32)
    want = jdecode(jnp.asarray(k), [jnp.asarray(r[owner]) for r in rows], span, tw,
                   jnp.asarray(tx[owner]), jnp.asarray(ty[owner]))
    got = tbin._decode_mask_tile(torch.from_numpy(k), [torch.from_numpy(r[owner]) for r in rows],
                                 span, tw, torch.from_numpy(tx[owner]), torch.from_numpy(ty[owner]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tight_masks_are_conservative():
    """Every candidate the port's mask rejects has alpha below the threshold
    at every pixel centre of its tile (brute force, as the reference's test
    does), and at least one rejected candidate is checked."""
    p = aniso_scene(120, seed=7)
    cfg = JConfig(tight_cull=True, max_tile_span=8)
    proj = jproject(*(jnp.asarray(p[k]) for k in KEYS[:4]), jax_camera(), cfg)
    m2 = torch.from_numpy(np.array(proj.means2d))
    radii = torch.from_numpy(np.array(proj.radii))
    conics = torch.from_numpy(np.array(proj.conics))
    ts, span = cfg.tile_size, cfg.max_tile_span
    th, tw = tbin.num_tiles(H, W, ts)
    x, y = m2[:, 0], m2[:, 1]
    rx, ry = radii[:, 0].float(), radii[:, 1].float()
    tx_min = torch.clamp(torch.floor((x - rx) / ts), 0, tw).int()
    ty_min = torch.clamp(torch.floor((y - ry) / ts), 0, th).int()
    valid = (radii > 0).all(1)
    sx = torch.where(valid, torch.clamp(torch.ceil((x + rx) / ts), 0, tw).int() - tx_min, 0)
    sy = torch.where(valid, torch.clamp(torch.ceil((y + ry) / ts), 0, th).int() - ty_min, 0)
    tx_min = tx_min + torch.clamp(sx - span, min=0) // 2
    ty_min = ty_min + torch.clamp(sy - span, min=0) // 2
    sx, sy = sx.clamp(max=span), sy.clamp(max=span)
    opac = torch.from_numpy(p["opacities"])
    counts, masks = tbin._tight_tile_masks(m2, conics, opac, tx_min, ty_min, sx, sy, ts, span,
                                           cfg.alpha_threshold)
    checked = 0
    for i in range(m2.shape[0]):
        for j in range(span * span):
            ky, kx = divmod(j, span)
            if kx >= sx[i] or ky >= sy[i]:
                continue
            if (int(masks[j // tbin._MASK_BITS][i]) >> (j % tbin._MASK_BITS)) & 1:
                continue
            px = (int(tx_min[i]) + kx) * ts + np.arange(ts) + 0.5
            py = (int(ty_min[i]) + ky) * ts + np.arange(ts) + 0.5
            dx = float(x[i]) - px[None, :]
            dy = float(y[i]) - py[:, None]
            a, b, c = conics[i].double().numpy()
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            assert (float(opac[i]) * np.exp(-sigma)).max() < cfg.alpha_threshold, (i, j)
            checked += 1
    assert checked > 50
    assert int(counts.sum()) == sum(bin(int(v)).count("1") for m in masks for v in m)


GOLDEN_CFG = JConfig(tile_capacity=128, chunk_size=32, max_tile_span=4, tight_cull=True)
GOLDEN_BG = (0.15, 0.05, 0.25)
GOLDEN_W = np.random.default_rng(5).uniform(-1, 1, (64, 64, 3)).astype(np.float32)


def golden_inputs():
    with np.load(ROOT / "tests" / "golden" / "render_3dgs.npz") as z:
        return {k[3:]: z[k] for k in z.files if k.startswith("in_")}


@functools.cache
def jax_golden_tight():
    """The JAX render's image, aux and gradients, computed once for both
    port routes."""
    jcam = JCamera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0, fy=70.0,
                          cx=32.0, cy=32.0)

    def jloss(params):
        img, depth, aux = jrender(*(params[k] for k in KEYS), jcam, sh_degree=2,
                                  background_color=GOLDEN_BG, config=GOLDEN_CFG,
                                  return_depth=True, return_aux=True)
        return jnp.mean(img * GOLDEN_W) + 1e-3 * jnp.mean(depth**2), (img, aux)

    return jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in golden_inputs().items()})


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_tight_render_matches_jax_at_golden_size(route):
    """tests/golden/render_3dgs.npz's inputs at 64x64 with tight culling
    (max_tile_span 4): forward and every gradient against the JAX render."""
    (_, (jimg, jaux)), want = jax_golden_tight()
    assert int(jaux.binning.tight_culled) > 0
    p, jcfg, bg, wimg = golden_inputs(), GOLDEN_CFG, GOLDEN_BG, GOLDEN_W
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), raster_impl=route)
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0, fy=70.0, cx=32.0,
                        cy=32.0, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    img, depth, aux = render_gaussians(*(leaves[k] for k in KEYS), cam, sh_degree=2,
                                       background_color=bg, config=cfg, return_depth=True,
                                       return_aux=True)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), rtol=0, atol=1e-5)
    for name, value in aux.binning._asdict().items():
        assert int(value) == int(getattr(jaux.binning, name)), name
    (torch.mean(img * torch.from_numpy(wimg)) + 1e-3 * torch.mean(depth**2)).backward()
    for k in KEYS:
        g, w = leaves[k].grad.numpy(), np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * float(np.abs(w).max()),
                                   err_msg=f"{route} {k}")
