"""PyTorch port: the blend kernels' per-row slot skip, on the CPU.

B1 and B2 (csrc/raster_fwd.cu, csrc/raster_bwd.cu) skip the slots that no
pixel of a warp's pixel rows can keep (csrc/common.cuh ``ms_row_may_apply``).
Its plain mirror, ``raster_cuda.row_may_apply_plain``, is held here to
brute force, at the golden vectors' scale:

(a) it never skips a (warp, slot) pair that some pixel of the warp keeps
    under the per-pixel rule (``_pixel_terms``' keep), on seeded numpy
    slots with a <= 0, indefinite conics (b^2 >= ac), opacities at and just
    above the threshold centred on pixel centres, and slots centred off the
    tile; and it does skip most pairs that no pixel comes near;
(b) ``raster_tiles_skips`` on CPU tensors: the count of skipped pairs from
    the plain stop indices, never above the pairs no pixel keeps among the
    ones the warps test, and ``stop_plain`` against a serial f32 walk;
(c) ``render_gaussians(raster_impl="cuda")`` on the CPU (the kernels'
    plain versions) against the JAX package's reference route ("xla"):
    image within the golden tolerance (rtol 5e-5, atol 5e-6) and every
    parameter's gradient within rtol 5e-5 and atol 5e-6 x max|g|.

The card's B1 count is held to ``skipped_pairs_plain`` in
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import render_gaussians as jrender
from mojosplat_tpu_torch import RenderConfig, config_from_jax, render_gaussians
from mojosplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
from mojosplat_tpu_torch.ops.raster_cuda import (
    B1_WARP_PIXELS, raster_tiles_skips, row_may_apply_plain, skipped_pairs_plain, stop_plain)
from mojosplat_tpu_torch.ops.rasterization import _pixel_terms, tile_pixel_centers

RTOL, ATOL = 5e-5, 5e-6
KEYS = ("means3d", "scales", "quats", "opacities", "features")
THR = np.float32(1.0 / 255.0)


def edge_slots(rng, n_tiles, tw, ts, cap, cp=4):
    """(6 + cp, n_tiles * cap) f32 slot table: seeded random ellipses around
    and off each tile, plus the edge cases of the row test."""
    tile = np.repeat(np.arange(n_tiles), cap)
    m = n_tiles * cap
    x0, y0 = (tile % tw) * ts, (tile // tw) * ts
    sx, sy = rng.uniform(0.3, 6.0, m), rng.uniform(0.3, 6.0, m)
    rho = rng.uniform(-0.95, 0.95, m)
    det = (sx * sy) ** 2 * (1 - rho**2)
    a, b, c = sy**2 / det, -rho * sx * sy / det, sx**2 / det
    mx = x0 + rng.uniform(-12, ts + 12, m)
    my = y0 + rng.uniform(-12, ts + 12, m)
    op = rng.uniform(0.0, 1.0, m)
    k = np.arange(m) % cap
    # a <= 0 and indefinite conics (b^2 >= ac).
    sel = k % 11 == 1
    a[sel] = rng.choice([0.0, -0.3, -1e-3], sel.sum())
    sel = k % 11 == 2
    b[sel] = np.sqrt(a[sel] * c[sel]) * rng.uniform(1.0, 3.0, sel.sum())
    sel = k % 11 == 3
    b[sel] = np.sqrt(a[sel] * c[sel])  # b^2 == ac: degenerate
    # Opacities at and just above the threshold, centred on a pixel centre.
    sel = k % 11 == 4
    op[sel] = THR * rng.choice([1.0, 1.0 + 1e-6, 1.0001, 1.01], sel.sum())
    mx[sel] = x0[sel] + rng.integers(0, ts, sel.sum()) + 0.5
    my[sel] = y0[sel] + rng.integers(0, ts, sel.sum()) + 0.5
    # Centred far off the tile, some with wide footprints.
    sel = k % 11 == 5
    mx[sel] = x0[sel] + rng.choice([-40.0, ts + 40.0], sel.sum())
    sel = k % 11 == 6
    my[sel] = y0[sel] + rng.uniform(-3.0, ts + 3.0, sel.sum())
    a[sel] *= 1e-3
    rows = [mx, my, a, b, c, op] + [rng.uniform(0, 1, m) for _ in range(cp)]
    return np.stack(rows).astype(np.float32)


def kept_by_warp(pdata, n_tiles, ts, tw, config):
    """(n_tiles, n_warps, cap): whether some pixel of each B1 warp keeps the
    slot under the per-pixel rule (brute force over every pixel)."""
    rows = pdata.shape[0]
    cap = pdata.shape[1] // n_tiles
    pd = pdata.reshape(rows, n_tiles, cap)
    px, py = tile_pixel_centers(torch.arange(n_tiles), ts, tw, torch.float32)
    valid = torch.ones((n_tiles, cap), dtype=torch.bool)
    keep = _pixel_terms(px, py, pd[0:2].permute(1, 2, 0), pd[2:5].permute(1, 2, 0),
                        pd[5], valid, config)[1]  # (n_tiles, P, cap)
    P, W = ts * ts, B1_WARP_PIXELS
    nw = -(-P // W)
    keep = torch.nn.functional.pad(keep, (0, 0, 0, nw * W - P))
    return keep.reshape(n_tiles, nw, W, cap).any(dim=2)


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_row_test_never_skips_a_kept_slot(ts):
    rng = np.random.default_rng(50 + ts)
    n_tiles, tw, cap = 6, 3, 352
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, chunk_size=32)
    pdata = torch.from_numpy(edge_slots(rng, n_tiles, tw, ts, cap))
    may = row_may_apply_plain(pdata, n_tiles, ts, tw, cfg)
    kept = kept_by_warp(pdata, n_tiles, ts, tw, cfg)
    assert may.shape == kept.shape == (n_tiles, -(-ts * ts // B1_WARP_PIXELS), cap)
    missed = kept & ~may
    assert not bool(missed.any()), f"{int(missed.sum())} kept (warp, slot) pairs skipped"
    # The cases that must be kept are: the slots at the threshold on a
    # pixel centre, and every a <= 0.
    k = torch.arange(cap)
    assert bool(kept[:, :, k % 11 == 4].any(dim=1).all())
    a = pdata.reshape(-1, n_tiles, cap)[2]
    assert bool(may.permute(1, 0, 2)[:, a <= 0].all())
    # And it skips most of what no pixel comes near.
    far = ~kept
    assert float((far & ~may).sum()) >= 0.6 * float(far.sum())


def serial_stop(pdata, counts, ts, tw, config):
    """Each pixel's stop by the kernel's serial f32 walk (numpy)."""
    rows = pdata.shape[0]
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // n_tiles
    pd = pdata.reshape(rows, n_tiles, cap).numpy()
    px, py = (v.numpy() for v in tile_pixel_centers(torch.arange(n_tiles), ts, tw,
                                                     torch.float32))
    f32 = np.float32
    out = np.empty((n_tiles, ts * ts), np.int32)
    for t in range(n_tiles):
        n = min(int(counts[t]), cap)
        T = np.ones(ts * ts, f32)
        stop = np.full(ts * ts, n, np.int32)
        alive = np.ones(ts * ts, bool)
        for k in range(n):
            mx, my, a, b, c, op = (f32(v) for v in pd[:6, t, k])
            dx, dy = mx - px[t], my - py[t]
            sigma = f32(0.5) * (a * dx * dx + c * dy * dy) + b * dx * dy
            with np.errstate(over="ignore"):  # sigma < 0 where a <= 0: never kept
                alpha = np.minimum(op * np.exp(-sigma), f32(config.max_alpha))
            keep = alive & (sigma >= 0) & (alpha >= f32(config.alpha_threshold))
            nxt = T * (f32(1) - alpha)
            ends = keep & (nxt <= f32(config.transmittance_eps))
            stop[ends] = k
            alive &= ~ends
            T = np.where(keep & ~ends, nxt, T)
        out[t] = stop
    return out


def test_skip_count_and_stop_on_cpu():
    rng = np.random.default_rng(5)
    ts, n_tiles, tw, cap = 16, 6, 3, 192
    cfg = RenderConfig(tile_size=ts, tile_capacity=cap, chunk_size=64, tile_batch=4)
    pdata = edge_slots(rng, n_tiles, tw, ts, cap)
    pdata[5] = np.clip(pdata[5] * 3.0, 0.0, 0.99)  # opaque enough that pixels stop
    pdata = torch.from_numpy(pdata)
    counts = torch.tensor([0, 1, 31, 100, 192, 250], dtype=torch.int32)
    skipped, stop = raster_tiles_skips(pdata, counts, ts, tw, cfg)
    nw = ts * ts // B1_WARP_PIXELS
    assert skipped.shape == (n_tiles, nw) and skipped.dtype == torch.int32
    assert stop.shape == (n_tiles, ts * ts) and stop.dtype == torch.int32
    want = serial_stop(pdata, counts, ts, tw, cfg)
    # The chunked product rounds apart from the serial one on a rare
    # boundary pixel.
    assert (stop.numpy() == want).mean() >= 0.995
    assert int(stop.min()) >= 0 and bool((stop <= counts.clamp(max=cap)[:, None]).all())
    assert bool((stop[4] < 192).any())  # some pixels stop early
    assert int(skipped[0].sum()) == 0
    # Skipped pairs lie among the tested ones that no pixel keeps.
    may = row_may_apply_plain(pdata, n_tiles, ts, tw, cfg)
    assert torch.equal(skipped, skipped_pairs_plain(may, counts, stop))
    kept = kept_by_warp(pdata, n_tiles, ts, tw, cfg)
    unkept = skipped_pairs_plain(kept, counts, stop)
    assert bool((skipped <= unkept).all()) and int(skipped.sum()) > 0


def scene(seed, n=160):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.6, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], 1)
    opac = rng.uniform(0.05, 0.95, n)
    opac[:4] = THR * np.array([0.999, 1.0, 1.001, 1.1])
    feats = rng.normal(0, 0.3, (n, 16, 3))
    feats[:, 0] += 0.8
    f32 = np.float32
    return dict(means3d=means.astype(f32),
                scales=np.stack([rng.normal(-2.0, 0.5, n), rng.normal(-3.0, 0.5, n),
                                 rng.normal(-2.5, 0.2, n)], 1).astype(f32),
                quats=rng.normal(size=(n, 4)).astype(f32),
                opacities=opac.astype(f32), features=feats.astype(f32))


@pytest.mark.parametrize("ts,tight", [(16, False), (32, True)])
def test_cuda_route_render_and_gradients_match_jax(ts, tight):
    p = scene(ts)
    H = W = 64
    jcam = JCamera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=70.0, fy=70.0,
                          cx=32.0, cy=32.0)
    jcfg = JConfig(raster_impl="xla", tile_size=ts, tile_capacity=128, chunk_size=32,
                   max_tile_span=4, tight_cull=tight)
    bg = np.array([0.15, 0.05, 0.25], np.float32)
    wimg = np.random.default_rng(3).uniform(-1, 1, (H, W, 3)).astype(np.float32)

    def jimage(params):
        return jrender(*(params[k] for k in KEYS), jcam, sh_degree=3,
                       background_color=bg, config=jcfg)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_img = np.asarray(jax.jit(jimage)(jp))
    want = jax.jit(jax.grad(lambda q: jnp.mean(jimage(q) * wimg)))(jp)

    cam = camera_from_numpy({f.name: getattr(jcam, f.name)
                             for f in dataclasses.fields(jcam)}, "cpu")
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), raster_impl="cuda")
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(p, "cpu").items()}
    img = render_gaussians(*(leaves[k] for k in KEYS), cam, sh_degree=3,
                           background_color=bg, config=cfg)
    np.testing.assert_allclose(img.detach().numpy(), want_img, rtol=RTOL, atol=ATOL)
    torch.mean(img * torch.from_numpy(wimg)).backward()
    for k in KEYS:
        got, ref = leaves[k].grad.numpy(), np.asarray(want[k])
        np.testing.assert_allclose(got, ref, rtol=RTOL,
                                   atol=ATOL * (float(np.abs(ref).max()) + 1e-12), err_msg=k)
