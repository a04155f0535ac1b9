"""Seeded surfel slot tables for the PyTorch port's tests of B6-B8.

Packed slot rows as ``ops/surfel_cuda.py`` lays them out (16 rows, or 18
with the maps), made from a seeded numpy generator with the port's own
column functions: plain disks (``surfel_pdata``), the edge cases the
kernels must get right (``surfel_edge_pdata``), and grazing disks with
threshold opacities (``grazing_pdata``). The card tests
(``test_torch_cuda.py``) and the CPU tests (``test_torch_surfel.py``,
``test_torch_surfel_skip.py``) share them.
"""

import numpy as np
import torch

from mojosplat_tpu_torch import Camera
from mojosplat_tpu_torch.ops.surfel_cuda import primed_surfel_columns
from mojosplat_tpu_torch.surfel import oriented_normal_columns, surfel_alpha_columns


def surfel_pdata(rng, n_tiles, tw, ts, cap, aux):
    """Packed surfel slot rows (16 or 18, n_tiles * cap): each slot a disk
    whose centre projects within 4 px of its tile, one in ten edge-on, made
    with the port's own column functions for a camera on the world axes."""
    H, W = n_tiles // tw * ts, tw * ts
    f = 1.2 * W
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=f, fy=f, cx=W / 2,
                        cy=H / 2, device="cpu")
    m = n_tiles * cap
    tile = np.repeat(np.arange(n_tiles), cap)
    sx = (tile % tw) * ts + rng.uniform(-4, ts + 4, m)
    sy = (tile // tw) * ts + rng.uniform(-4, ts + 4, m)
    z = rng.uniform(1.5, 4.0, m)
    means = np.stack([(sx - W / 2) / f * z, (sy - H / 2) / f * z, z], 1)
    scales = np.log(rng.uniform(0.5, 8.0, (m, 2)) * z[:, None] / f)
    quats = rng.normal(size=(m, 4))
    quats[rng.random(m) < 0.1] = [np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0]
    opac = rng.uniform(0.05, 0.99, m)
    cols = surfel_alpha_columns(
        *(torch.from_numpy(a.astype(np.float32)) for a in (means, scales, quats, opac)), cam)
    pcols = list(primed_surfel_columns(cols, cam))
    pcols += [torch.from_numpy(rng.uniform(0, 1.5, m).astype(np.float32)) for _ in range(3)]
    pcols += list(oriented_normal_columns(cols)) if aux else [torch.zeros(m)]
    return torch.stack(pcols).numpy()


def surfel_edge_pdata(rng, n_tiles, tw, ts, cap, aux):
    """surfel_pdata with B8's edge cases mixed in (slot index k mod 7):
    failed solves (the two disk axes equal, so det A = 0 at every pixel),
    disks shrunk 1000x (s2 clamps at 1e4 away from their centre), and
    opacities at the alpha threshold with the projected centre on a pixel
    centre (alpha exactly 1/255 there); no slot of chunk 3 of tile 11 is
    applied (opacity 0), and tile 10's disks cover it at opacity 0.97, so
    its pixels stop within the first chunks."""
    pd = surfel_pdata(rng, n_tiles, tw, ts, cap, aux)
    k = np.arange(n_tiles * cap) % 7
    tile = np.repeat(np.arange(n_tiles), cap)
    slot = np.arange(n_tiles * cap) % cap
    pd[6:9, k == 1] = pd[3:6, k == 1]
    pd[3:9, k == 2] *= np.float32(1e-3)
    sel = k == 3
    pd[11, sel] = np.float32(1.0 / 255.0)
    pd[9, sel] = (tile[sel] % tw) * ts + 3.5
    pd[10, sel] = (tile[sel] // tw) * ts + 1.5
    pd[11, (tile == 11) & (slot // 16 == 3)] = 0.0
    big = tile == 10
    pd[3:9, big] *= np.float32(100.0)
    pd[11, big] = np.float32(0.97)
    return pd


def grazing_pdata(rng, n_tiles, tw, ts, cap, aux):
    """surfel_edge_pdata with every third slot grazing: its second axis
    nearly along the ray to its centre (b' = lambda qc' with a relative
    perturbation of 1e-6 to 1e-2), so det A is near 0 and changes sign
    along the pixel rows through the disk; and opacities at, just above and
    just below the threshold, 0 and NaN at every 11th slot."""
    pd = surfel_edge_pdata(rng, n_tiles, tw, ts, cap, aux)
    thr = np.float32(1.0 / 255.0)
    m = n_tiles * cap
    k = np.arange(m)
    sel = k % 3 == 0
    lam = rng.choice([-1.0, 1.0], sel.sum()) * rng.uniform(0.01, 2.0, sel.sum())
    noise = rng.choice([1e-6, 1e-4, 1e-2], (3, sel.sum())) * rng.normal(size=(3, sel.sum()))
    pd[6:9, sel] = (pd[0:3, sel] * lam * (1.0 + noise)).astype(np.float32)
    sel = k % 11 == 5
    pd[11, sel] = rng.choice([thr, thr * np.float32(1.0 + 1e-6), thr * np.float32(1.0 - 1e-6),
                              np.float32(0.0), np.float32(np.nan)], sel.sum())
    return pd


def ortho_pdata(rng, n_tiles, tw, ts, cap, aux):
    """Packed slot rows of disks seen by an ortho camera (its z rows (1, 0,
    0), ``primed_surfel_columns``), made with the port's own column
    functions: each disk's centre within 4 px of its tile, one in ten
    edge-on (the plane holds the view direction, so det A = 0 at every
    pixel), every third nearly so (its normal tilted 1e-6 to 1e-2 rad from
    the image plane: det A near 0), and opacities at, just above and below
    the threshold, 0 and NaN at every 11th slot."""
    H, W = n_tiles // tw * ts, tw * ts
    f = W / 4.0  # pixels per world unit
    cam = Camera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=f, fy=1.1 * f, cx=W / 2,
                        cy=H / 2, device="cpu", camera_model="ortho")
    m = n_tiles * cap
    k = np.arange(m)
    tile = np.repeat(np.arange(n_tiles), cap)
    sx = (tile % tw) * ts + rng.uniform(-4, ts + 4, m)
    sy = (tile // tw) * ts + rng.uniform(-4, ts + 4, m)
    means = np.stack([(sx - W / 2) / f, (sy - H / 2) / (1.1 * f), rng.uniform(1.0, 4.0, m)], 1)
    scales = np.log(rng.uniform(0.5, 8.0, (m, 2)) / f)
    quats = rng.normal(size=(m, 4))
    # A rotation by pi/2 - eps about x turns the disk (tangents x and y) to
    # hold the z axis up to eps.
    eps = np.where(k % 10 == 0, 0.0, rng.choice([1e-6, 1e-4, 1e-2], m))
    half = (np.pi / 2 - eps) / 2
    graze = (k % 10 == 0) | (k % 3 == 0)
    quats[graze] = np.stack([np.cos(half), np.sin(half), 0 * half, 0 * half], 1)[graze]
    opac = rng.uniform(0.05, 0.99, m)
    thr = 1.0 / 255.0
    sel = k % 11 == 5
    opac[sel] = rng.choice([thr, thr * (1.0 + 1e-6), thr * (1.0 - 1e-6), 0.0, np.nan], sel.sum())
    cols = surfel_alpha_columns(
        *(torch.from_numpy(a.astype(np.float32)) for a in (means, scales, quats, opac)), cam)
    pcols = list(primed_surfel_columns(cols, cam))
    pcols += [torch.from_numpy(rng.uniform(0, 1.5, m).astype(np.float32)) for _ in range(3)]
    pcols += list(oriented_normal_columns(cols)) if aux else [torch.zeros(m)]
    return torch.stack(pcols).numpy()
