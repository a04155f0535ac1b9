"""Plain 3DGS (Kerbl et al., 2023) and 2DGS (Huang et al., 2024) renders
with their gradients, written from the papers' equations and the render
rules a configuration states, in the dtype of the inputs.

Per pixel, front to back over the gaussians that touch its tile, sorted by
camera depth (ties by index):

    alpha = min(opacity * response, max_alpha)
    skip the gaussian if alpha < alpha_threshold (3DGS: also if sigma < 0)
    stop before the first gaussian that would take T to <= transmittance_eps
    C += colour * alpha * T;  T *= 1 - alpha;  finally C += T * background

A gaussian touches the tiles of its screen rectangle (centre +- radius,
the radius ceil(extend * sqrt(covariance diagonal)), the extend
opacity-aware); a surfel is binned as its flattened gaussian with the
radius widened to its low-pass filter's support. Nothing is dropped: every
(tile, gaussian) pair of every rectangle is blended.

The blend runs on blocks of tiles with similar counts, a chunk of slots at
a time, so that it fits on one card. Gradients take two passes: a forward
without autograd gives the outputs and how many chunks each block needs;
the caller's loss on those outputs gives their cotangents; each block is
then recomputed under autograd and differentiated against its own
cotangents into per-gaussian leaves, which autograd carries back through
the projection and the SH colour to the raw parameters.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
FILTER_SIGMA2 = 0.5  # 2DGS's screen-space low-pass, (sqrt(2) / 2)^2 px^2
FLAT_LOG_SCALE = -13.8  # a surfel's third log-scale when it is binned


class View(NamedTuple):
    """A pinhole camera: world-to-camera R (3, 3) and T (3,), intrinsics in
    pixels, the image size and the near / far planes."""

    R: torch.Tensor
    T: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    H: int
    W: int
    near: float
    far: float

    def position(self) -> torch.Tensor:
        return -(self.R.T @ self.T)

    def to(self, dtype) -> "View":
        return self._replace(R=self.R.to(dtype), T=self.T.to(dtype))


class Rules(NamedTuple):
    """The render rules of a configuration's ``render`` block."""

    tile_size: int
    eps2d: float
    alpha_threshold: float
    max_alpha: float
    transmittance_eps: float
    radius_extend: float

    @staticmethod
    def of(render: dict) -> "Rules":
        if render.get("antialiased", False) or render.get("radius_clip", 0.0) != 0.0 \
                or not render.get("opacity_aware_radius", True) \
                or render.get("projection_mode", "ewa") != "ewa":
            raise ValueError("the reference renders EWA splats with an opacity-aware "
                             "radius, no radius clip and no antialiasing")
        return Rules(render["tile_size"], render.get("eps2d", 0.3),
                     render.get("alpha_threshold", 1.0 / 255.0),
                     render.get("max_alpha", 0.999),
                     render.get("transmittance_eps", 1e-4),
                     render.get("radius_extend", 3.33))


# ---------------------------------------------------------------- colour

def sh_colour(features, means, campos, degree: int):
    """View-dependent RGB of (N, K, 3) real-SH coefficients at the
    directions from the camera to the means: the band sums + 0.5, floored
    at 0."""
    d = means - campos[None, :]
    d = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-24)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
                  SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    B = torch.stack(basis, dim=-1)
    colour = torch.einsum("nk,nkc->nc", B, features[:, : B.shape[1], :]) + 0.5
    return torch.maximum(colour, colour.new_zeros(()))


# ------------------------------------------------------------ projection

def quat_rotmat(quats):
    """(N, 3, 3) rotations of wxyz quaternions, normalised first."""
    q = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


class Splats(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixels
    conics: torch.Tensor  # (N, 3) inverse 2D covariance [a, b, c]
    depth: torch.Tensor  # (N,) camera z
    radii: torch.Tensor  # (N, 2) int64, 0 where culled


def ewa_project(means, log_scales, quats, opacities, view: View, rules: Rules) -> Splats:
    """EWA splatting (Zwicker et al. 2002) as 3DGS uses it: the camera-frame
    covariance through the perspective map's Jacobian, with the guard band
    of 0.3 tan(fov) on the Jacobian's point, dilated by eps2d."""
    dt = means.dtype
    Rm = quat_rotmat(quats) * torch.exp(log_scales)[:, None, :]
    cov3 = Rm @ Rm.transpose(1, 2)
    Rc, Tc = view.R.to(dt), view.T.to(dt)
    mc = means @ Rc.T + Tc
    covc = Rc @ cov3 @ Rc.T
    tx, ty, tz = mc.unbind(-1)
    tz_safe = torch.where(tz > min(view.near, 1e-3), tz, torch.ones_like(tz))
    fx, fy, cx, cy = view.fx, view.fy, view.cx, view.cy
    lim_x = (0.5 * view.W / fx) * 0.3
    lim_y = (0.5 * view.H / fy) * 0.3
    txc = tz_safe * torch.clamp(tx / tz_safe, -(cx / fx + lim_x), (view.W - cx) / fx + lim_x)
    tyc = tz_safe * torch.clamp(ty / tz_safe, -(cy / fy + lim_y), (view.H - cy) / fy + lim_y)
    zero = torch.zeros_like(tz)
    J = torch.stack([fx / tz_safe, zero, -fx * txc / (tz_safe * tz_safe),
                     zero, fy / tz_safe, -fy * tyc / (tz_safe * tz_safe)], dim=-1).reshape(-1, 2, 3)
    cov2 = J @ covc @ J.transpose(1, 2)
    c00 = cov2[:, 0, 0] + rules.eps2d
    c11 = cov2[:, 1, 1] + rules.eps2d
    c01 = cov2[:, 0, 1]
    det = torch.clamp(c00 * c11 - c01 * c01, min=1e-10)
    conics = torch.stack([c11 / det, -c01 / det, c00 / det], dim=-1)
    means2d = torch.stack([fx * tx / tz_safe + cx, fy * ty / tz_safe + cy], dim=-1)

    with torch.no_grad():
        thr = rules.alpha_threshold
        extend = torch.clamp(torch.sqrt(2.0 * torch.log(torch.clamp(opacities, min=thr) / thr)),
                             max=rules.radius_extend)
        rx = torch.ceil(extend * torch.sqrt(torch.clamp(c00, min=0.0)))
        ry = torch.ceil(extend * torch.sqrt(torch.clamp(c11, min=0.0)))
        x, y = means2d[:, 0], means2d[:, 1]
        keep = ((tz > view.near) & (tz < view.far) & (opacities >= thr)
                & ((rx > 0) | (ry > 0))
                & (x + rx > 0) & (x - rx < view.W) & (y + ry > 0) & (y - ry < view.H))
        radii = torch.where(keep[:, None], torch.stack([rx, ry], -1), torch.zeros_like(
            torch.stack([rx, ry], -1))).to(torch.int64)
    return Splats(means2d, conics, tz, radii)


# --------------------------------------------------------------- binning

class Tiles(NamedTuple):
    ids: torch.Tensor  # (M,) int64 gaussian of each (tile, gaussian) pair, by tile then depth
    starts: torch.Tensor  # (n_tiles + 1,) int64 first pair of each tile
    th: int
    tw: int
    widest: int  # widest rectangle side, in tiles
    H: int
    W: int


def bin_tiles(means2d, radii, depth, H: int, W: int, ts: int) -> Tiles:
    """Every (tile, gaussian) pair of the gaussians' screen rectangles
    [floor((c - r) / ts), ceil((c + r) / ts)) clipped to the grid, ordered
    by tile, then depth, then index."""
    th, tw = -(-H // ts), -(-W // ts)
    n = means2d.shape[0]
    dev = means2d.device
    with torch.no_grad():
        x, y = means2d[:, 0].detach(), means2d[:, 1].detach()
        rx, ry = radii[:, 0].to(x.dtype), radii[:, 1].to(x.dtype)
        tx0 = torch.clamp(torch.floor((x - rx) / ts), 0, tw).to(torch.int64)
        tx1 = torch.clamp(torch.ceil((x + rx) / ts), 0, tw).to(torch.int64)
        ty0 = torch.clamp(torch.floor((y - ry) / ts), 0, th).to(torch.int64)
        ty1 = torch.clamp(torch.ceil((y + ry) / ts), 0, th).to(torch.int64)
        live = (radii[:, 0] > 0) & (radii[:, 1] > 0)
        sx = torch.where(live, tx1 - tx0, 0)
        sy = torch.where(live, ty1 - ty0, 0)
        counts = sx * sy
        gid = torch.repeat_interleave(torch.arange(n, device=dev), counts)
        k = torch.arange(gid.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[gid]
        w = sx[gid]
        tile = (ty0[gid] + k // w) * tw + tx0[gid] + k % w
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        rank[torch.sort(depth.detach(), stable=True).indices] = torch.arange(n, device=dev)
        order = torch.argsort(tile * n + rank[gid])
        starts = torch.searchsorted(tile[order], torch.arange(th * tw + 1, device=dev))
        widest = int(torch.maximum(sx, sy).max()) if n else 0
    return Tiles(gid[order], starts, th, tw, widest, H, W)


# ----------------------------------------------------------------- blend

class Family(NamedTuple):
    """How one primitive family blends: its per-gaussian field count, the
    field columns blended as colour channels, the per-pixel values it
    blends (the 2DGS depth moments), and its alpha
    ``alpha(px, py, f, live) -> (alpha (B, P, K) zeroed where skipped,
    vals (B, P, K, V) or None)`` of gathered fields f (B, K, F)."""

    colour: slice
    n_vals: int
    alpha: Callable


def splat_alpha(rules: Rules):
    def alpha(px, py, f, live):
        dx = f[..., None, :, 0] - px[..., :, None]
        dy = f[..., None, :, 1] - py[..., :, None]
        a, b, c = f[..., None, :, 2], f[..., None, :, 3], f[..., None, :, 4]
        sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
        al = torch.clamp(f[..., None, :, 5] * torch.exp(-sigma), max=rules.max_alpha)
        keep = live[..., None, :] & (sigma >= 0) & (al >= rules.alpha_threshold)
        return torch.where(keep, al, torch.zeros_like(al)), None
    return alpha


def surfel_alpha(rules: Rules, view: View, with_vals: bool):
    """2DGS: the exact ray / disk intersection (u, v) in the disk's scaled
    tangent frame, the response max(exp(-(u^2 + v^2) / 2), the low-pass
    filter around the projected centre); with ``with_vals`` the depth of
    the intersection (the centre's where the filter wins) and its square."""
    def alpha(px, py, f, live):
        g = f[..., None, :, :]  # (B, 1, K, F)
        xn = ((px - view.cx) / view.fx)[..., :, None]
        yn = ((py - view.cy) / view.fy)[..., :, None]
        qx, qy, qz = g[..., 0], g[..., 1], g[..., 2]
        ax, ay, az = g[..., 3], g[..., 4], g[..., 5]
        bx, by, bz = g[..., 6], g[..., 7], g[..., 8]
        A11, A12 = ax - xn * az, bx - xn * bz
        A21, A22 = ay - yn * az, by - yn * bz
        r1, r2 = xn * qz - qx, yn * qz - qy
        det = A11 * A22 - A12 * A21
        ok = torch.abs(det) > 1e-9
        det = torch.where(ok, det, torch.ones_like(det))
        u = (r1 * A22 - r2 * A12) / det
        v = (A11 * r2 - A21 * r1) / det
        g_surf = torch.where(ok, torch.exp(-0.5 * torch.clamp(u * u + v * v, max=1e4)),
                             torch.zeros_like(u))
        dx, dy = px[..., :, None] - g[..., 9], py[..., :, None] - g[..., 10]
        g_filt = torch.exp(-(dx * dx + dy * dy) / (2.0 * FILTER_SIGMA2))
        al = torch.clamp(g[..., 11] * torch.maximum(g_surf, g_filt), max=rules.max_alpha)
        keep = live[..., None, :] & (al >= rules.alpha_threshold)
        al = torch.where(keep, al, torch.zeros_like(al))
        if not with_vals:
            return al, None
        z = torch.where(ok & (g_surf >= g_filt), qz + u * az + v * bz, qz.expand_as(u))
        return al, torch.stack([z, z * z], dim=-1)
    return alpha


class Blend(NamedTuple):
    out: torch.Tensor  # (n_tiles, P, C + V + 1): channels, values, transmittance
    pairs: int  # (pixel, gaussian) pairs of the image that contributed to the blend
    walked: torch.Tensor  # (n_tiles,) chunks each tile walked before all its pixels stopped


def _walk(fields, tiles: Tiles, tids, fam: Family, rules: Rules, K: int, stop=None):
    """Blend the tiles ``tids`` a chunk of K slots at a time. A tile leaves
    the walk when all its pixels stopped or its slots ran out or, given
    ``stop`` (its chunk count, descending along ``tids``), after that many
    chunks. Returns ((B, P, C + V + 1) outputs in ``tids`` order, the
    contributing pairs, the chunks each tile walked)."""
    dev, dt = fields.device, fields.dtype
    ts, P = rules.tile_size, rules.tile_size ** 2
    tids = tids.to(dev)
    B = tids.shape[0]
    start = tiles.starts[tids]
    count = tiles.starts[tids + 1] - start
    p = torch.arange(P, device=dev)
    px = ((tids % tiles.tw)[:, None] * ts + p % ts).to(dt) + 0.5
    py = ((tids // tiles.tw)[:, None] * ts + p // ts).to(dt) + 0.5
    inside = ((px < tiles.W) & (py < tiles.H))[..., None]  # grid pixels past the edge
    C = fam.colour.stop - fam.colour.start
    T = torch.ones((B, P), dtype=dt, device=dev)
    done = torch.zeros((B, P), dtype=torch.bool, device=dev)
    acc = torch.zeros((B, P, C), dtype=dt, device=dev)
    accv = torch.zeros((B, P, fam.n_vals), dtype=dt, device=dev)
    row = torch.arange(B, device=dev)
    walked = torch.zeros(B, dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    parts, rows = [], []
    last = tiles.ids.shape[0] - 1
    k = 0
    while row.numel():
        j = k * K + torch.arange(K, device=dev)
        live = j[None, :] < count[:, None]
        gid = torch.where(live, tiles.ids[torch.clamp(start[:, None] + j, max=last)], 0)
        f = fields[gid]
        alpha, vals = fam.alpha(px, py, f, live)
        T_after = T[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
        applied = (T_after > rules.transmittance_eps) & ~done[..., None]
        a_eff = torch.where(applied, alpha, torch.zeros_like(alpha))
        one_m = 1.0 - a_eff
        excl = torch.cat([torch.ones_like(one_m[..., :1]), torch.cumprod(one_m, -1)[..., :-1]], -1)
        w = a_eff * (T[..., None] * excl)
        acc = acc + w @ f[..., fam.colour]
        if fam.n_vals:
            accv = accv + torch.einsum("bpk,bpkv->bpv", w, vals)
        pairs += (applied & (alpha > 0) & inside).sum()
        T = T * torch.prod(one_m, dim=-1)
        done = done | (T_after[..., -1] <= rules.transmittance_eps)
        k += 1
        if stop is None:  # the tiles whose pixels all stopped or whose slots ran out
            keep = ~(done.all(dim=-1) | (k * K >= count))
            if bool(keep.all()):
                continue
            gone = ~keep
        else:  # the tiles past their chunk count: a suffix, known on the host
            n = sum(int(s) > k for s in stop)
            if n == row.shape[0]:
                continue
            keep, gone = slice(0, n), slice(n, None)
        parts.append(torch.cat([acc, accv, T[..., None]], dim=-1)[gone])
        rows.append(row[gone])
        walked[row[gone]] = k
        row, start, count, px, py, inside, T, done, acc, accv = (
            x[keep] for x in (row, start, count, px, py, inside, T, done, acc, accv))
    out = torch.cat(parts)[torch.argsort(torch.cat(rows))]
    return out, pairs, walked


def blend(fields, tiles: Tiles, fam: Family, rules: Rules, *, K: int = 128,
          elems: int = 1 << 27) -> Blend:
    """Forward blend of every tile, without autograd, ``elems`` (tile,
    pixel, slot) elements at a time."""
    P = rules.tile_size ** 2
    C = fam.colour.stop - fam.colour.start
    n_tiles = tiles.th * tiles.tw
    out = torch.zeros((n_tiles, P, C + fam.n_vals + 1), dtype=fields.dtype, device=fields.device)
    out[..., -1] = 1.0
    walked = torch.zeros(n_tiles, dtype=torch.int64)
    counts = (tiles.starts[1:] - tiles.starts[:-1]).cpu()
    live = torch.nonzero(counts > 0)[:, 0]
    live = live[torch.argsort(counts[live], descending=True, stable=True)]
    pairs, step = 0, max(1, elems // (P * K))
    with torch.no_grad():
        for i in range(0, live.shape[0], step):
            block = live[i : i + step]
            o, n, w = _walk(fields, tiles, block, fam, rules, K)
            out[block.to(out.device)] = o
            walked[block] = w.cpu()
            pairs += int(n)
    return Blend(out, pairs, walked)


def blend_grad(fields, tiles: Tiles, fam: Family, rules: Rules, fwd: Blend, cot, *,
               K: int = 128, elems: int = 1 << 27):
    """d loss / d fields, from the cotangent ``cot`` of ``fwd.out``: the
    tiles recomputed under autograd over the chunks the forward walked, in
    blocks of at most ``elems`` (tile, pixel, slot) elements, each
    differentiated against its own cotangents."""
    leaf = fields.detach().requires_grad_(True)
    P = rules.tile_size ** 2
    live = torch.nonzero(fwd.walked > 0)[:, 0]
    live = live[torch.argsort(fwd.walked[live], descending=True, stable=True)]
    i = 0
    while i < live.shape[0]:
        n, size = 0, 0
        while i + n < live.shape[0] and (n == 0 or size + P * K * int(fwd.walked[live[i + n]]) <= elems):
            size += P * K * int(fwd.walked[live[i + n]])
            n += 1
        block = live[i : i + n]
        o, _, _ = _walk(leaf, tiles, block, fam, rules, K, stop=fwd.walked[block].tolist())
        torch.autograd.backward(o, cot[block.to(cot.device)])
        i += n
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


def assemble(out, tiles: Tiles, ts: int, H: int, W: int):
    """(n_tiles, P, c) tile outputs -> (H, W, c) image."""
    c = out.shape[-1]
    img = out.reshape(tiles.th, tiles.tw, ts, ts, c).permute(0, 2, 1, 3, 4)
    return img.reshape(tiles.th * ts, tiles.tw * ts, c)[:H, :W]


def disassemble(img, tiles: Tiles, ts: int):
    """(H, W, c) image (cotangent) -> (n_tiles, P, c), zero past the edge."""
    H, W, c = img.shape
    pad = img.new_zeros((tiles.th * ts, tiles.tw * ts, c))
    pad[:H, :W] = img
    return pad.reshape(tiles.th, ts, tiles.tw, ts, c).permute(0, 2, 1, 3, 4).reshape(-1, ts * ts, c)


# -------------------------------------------------------------- families

def activate(raw: dict) -> dict:
    out = dict(raw)
    out["opacities"] = torch.sigmoid(out.pop("opacities_raw"))
    return out


def splat_fields(p: dict, view: View, rules: Rules, sh_degree: int):
    """3DGS: (fields (N, 9) [mean2d, conic, opacity, rgb], tiles)."""
    s = ewa_project(p["means3d"], p["scales"], p["quats"], p["opacities"], view, rules)
    rgb = sh_colour(p["features"], p["means3d"], view.position().to(p["means3d"].dtype), sh_degree)
    fields = torch.cat([s.means2d, s.conics, p["opacities"][:, None], rgb], dim=-1)
    tiles = bin_tiles(s.means2d, s.radii, s.depth, view.H, view.W, rules.tile_size)
    return fields, tiles


def surfel_fields(p: dict, view: View, rules: Rules, sh_degree: int):
    """2DGS: (fields (N, 18) [camera-frame centre, scaled tangent axes a
    and b, projected centre, opacity, rgb, viewer-facing unit normal],
    tiles)."""
    means, ls, op = p["means3d"], p["scales"][:, :2], p["opacities"]
    dt = means.dtype
    n = means.shape[0]
    flat = torch.cat([ls, torch.full((n, 1), FLAT_LOG_SCALE, dtype=dt, device=means.device)], -1)
    s = ewa_project(means, flat.detach(), p["quats"].detach(), op.detach(), view, rules)
    with torch.no_grad():
        thr = rules.alpha_threshold
        filt = torch.ceil(torch.sqrt(2.0 * FILTER_SIGMA2 * torch.log(
            torch.clamp(op, min=thr) / thr))).to(torch.int64)
        radii = torch.where(s.radii > 0, torch.maximum(s.radii, filt[:, None]), s.radii)
    tiles = bin_tiles(s.means2d, radii, s.depth, view.H, view.W, rules.tile_size)

    Rq = quat_rotmat(p["quats"])
    Rc, Tc = view.R.to(dt), view.T.to(dt)
    qc = means @ Rc.T + Tc
    a = (Rq[:, :, 0] @ Rc.T) * torch.exp(ls[:, 0:1])
    b = (Rq[:, :, 1] @ Rc.T) * torch.exp(ls[:, 1:2])
    z = torch.clamp(qc[:, 2], min=1e-6)
    c2 = torch.stack([view.fx * qc[:, 0] / z + view.cx, view.fy * qc[:, 1] / z + view.cy], -1)
    nrm = torch.linalg.cross(a, b, dim=-1)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-12)
    nrm = torch.where(nrm[:, 2:3] > 0, -nrm, nrm)
    rgb = sh_colour(p["features"], means, view.position().to(dt), sh_degree)
    fields = torch.cat([qc, a, b, c2, op[:, None], rgb, nrm], dim=-1)
    return fields, tiles


def family(name: str, rules: Rules, view: View, maps: bool) -> Family:
    if name == "3dgs":
        return Family(slice(6, 9), 0, splat_alpha(rules))
    if name == "2dgs":
        return Family(slice(12, 18 if maps else 15), 2 if maps else 0,
                      surfel_alpha(rules, view, maps))
    raise ValueError(f"unknown family {name!r}")


def fields_of(name: str, p: dict, view: View, rules: Rules, sh_degree: int):
    return (splat_fields if name == "3dgs" else surfel_fields)(p, view, rules, sh_degree)


# ------------------------------------------------------------------ maps

def maps_of(img_out, maps: bool) -> dict:
    """Named (H, W, ...) outputs of an assembled blend: rgb and T; with the
    maps also the blended normals, the depth moments m1 = sum(w z) and
    m2 = sum(w z^2), and the distortion 2 (alpha m2 - m1^2)."""
    out = {"rgb": img_out[..., 0:3], "T": img_out[..., -1]}
    if maps:
        out["normals"] = img_out[..., 3:6]
        out["depth"] = img_out[..., 6]
        alpha = 1.0 - out["T"]
        out["distortion"] = 2.0 * (alpha * img_out[..., 7] - img_out[..., 6] ** 2)
    return out


def depth_normals(edepth, view: View):
    """Camera-frame normals of the expected-depth map: each pixel
    backprojected to z (xn, yn, 1), the normalised cross product of the
    centred screen-space differences, turned toward the viewer. Past the
    top and bottom rows the depth is extended linearly (2 d0 - d1) and
    backprojected at its own row; along a row the edge difference is
    one-sided."""
    H, W = edepth.shape
    dt, dev = edepth.dtype, edepth.device
    d = torch.cat([(2 * edepth[0] - edepth[1])[None], edepth,
                   (2 * edepth[-1] - edepth[-2])[None]], dim=0)
    xn = ((torch.arange(W, dtype=dt, device=dev) + 0.5 - view.cx) / view.fx)[None, :]
    yn = ((torch.arange(-1, H + 1, dtype=dt, device=dev) + 0.5 - view.cy) / view.fy)[:, None]
    pts = torch.stack([d * xn, d * yn, d], dim=-1)
    dx = torch.gradient(pts[1:-1], dim=1)[0]
    dy = 0.5 * (pts[2:] - pts[:-2])
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    return torch.where(n[..., 2:3] > 0, -n, n)


def surfel_loss(m: dict, target, view: View, normal_weight: float, distortion_weight: float):
    """2DGS's training loss of one view: the mean squared error, plus
    ``distortion_weight`` x the mean distortion, plus ``normal_weight`` x
    the alpha-weighted mean of 1 - n_render . n_depth over the pixels with
    coverage above 0.5 (the depth normals carry no gradient)."""
    loss = torch.sum((m["rgb"] - target) ** 2) / target.numel()
    if distortion_weight:
        loss = loss + distortion_weight * torch.sum(m["distortion"]) / (target.numel() // 3)
    if normal_weight:
        alpha = 1.0 - m["T"]
        cov = alpha > 0.5
        safe = torch.where(cov, torch.clamp(alpha, min=1e-6), torch.ones_like(alpha))
        edepth = torch.where(cov, m["depth"], torch.ones_like(alpha)) / safe
        nr = torch.where(cov[..., None], m["normals"] / safe[..., None],
                         torch.tensor([0.0, 0.0, -1.0], dtype=alpha.dtype, device=alpha.device))
        nr = nr / torch.clamp(torch.linalg.norm(nr, dim=-1, keepdim=True), min=1e-12)
        nd = depth_normals(edepth.detach(), view)
        w = torch.where(cov, alpha, torch.zeros_like(alpha))
        num = torch.sum(w * (1.0 - torch.sum(nr * nd, dim=-1)))
        loss = loss + normal_weight * num / torch.clamp(torch.sum(w), min=1.0)
    return loss


# ----------------------------------------------------------------- entry

class Render(NamedTuple):
    maps: dict  # rgb (H, W, 3) with the background, T, and the 2DGS maps
    num_isects: int
    pairs: int
    widest: int


def render(name: str, raw: dict, view: View, rules: Rules, sh_degree: int, background,
           maps: bool = False, **blend_kw) -> Render:
    """Forward render of the raw parameters (opacities as logits)."""
    with torch.no_grad():
        p = activate(raw)
        fields, tiles = fields_of(name, p, view, rules, sh_degree)
        fwd = blend(fields, tiles, family(name, rules, view, maps), rules, **blend_kw)
    m = maps_of(assemble(fwd.out, tiles, rules.tile_size, view.H, view.W), maps)
    bg = torch.as_tensor(background, dtype=fields.dtype, device=fields.device)
    m["rgb"] = m["rgb"] + m["T"][..., None] * bg
    return Render(m, int(tiles.ids.shape[0]), fwd.pairs, tiles.widest)


def loss_and_grads(name: str, raw: dict, view: View, target, rules: Rules, sh_degree: int,
                   loss_fn, maps: bool = False, **blend_kw):
    """(loss, {leaf: gradient}, Render) of ``loss_fn(maps)`` for one view
    on a black background; ``raw`` holds the raw leaves."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
    p = activate(leaves)
    fields, tiles = fields_of(name, p, view, rules, sh_degree)
    fam = family(name, rules, view, maps)
    fwd = blend(fields.detach(), tiles, fam, rules, **blend_kw)
    img = assemble(fwd.out, tiles, rules.tile_size, view.H, view.W).detach().requires_grad_(True)
    m = maps_of(img, maps)
    loss = loss_fn(m, target, view)
    loss.backward()
    cot = disassemble(img.grad, tiles, rules.tile_size)
    d_fields = blend_grad(fields, tiles, fam, rules, fwd, cot, **blend_kw)
    torch.autograd.backward(fields, d_fields)
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in leaves.items()}
    out = {k: v.detach() for k, v in m.items()}
    return loss.detach(), grads, Render(out, int(tiles.ids.shape[0]), fwd.pairs, tiles.widest)


def l2_loss(m, target, view):
    return torch.mean((m["rgb"] - target) ** 2)


class Adam:
    """Adam (Kingma and Ba, 2015) with PyTorch's defaults: betas (0.9,
    0.999), eps 1e-8, bias-corrected moments, eps added to the corrected
    root."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t = 0
        self.m: dict = {}
        self.v: dict = {}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            denom = torch.sqrt(v) / math.sqrt(1 - self.b2 ** self.t) + self.eps
            out[k] = p - (self.lr / (1 - self.b1 ** self.t)) * m / denom
        return out
