"""Gaussian-sharded pipeline: all-to-all routing of the tile slots.

Counterpart of ``mojosplat_tpu.parallel.gauss_sharded``. Nothing is
replicated: on a 1-D (``"gauss"``,) mesh of n ranks each rank owns N / n
contiguous gaussians (their parameters, gradients and Adam moments) and
the horizontal slab of H / n image rows at its mesh index, so the largest
scene grows with the memory of all the cards (ZeRO-3).

Per rank:

  1. project and SH-evaluate the local gaussians;
  2. bin them against the FULL tile grid (B4 on the ``"cuda"`` route); the
     (tile, depth)-sorted slots are grouped by destination, because the
     slabs are contiguous runs of tiles;
  3. cut the sorted slots into one window of ``cap_pair`` slots per
     destination (slots past a window are counted in ``route_overflow``,
     never dropped silently) and gather each slot's blend fields, row-major
     (slot, field): the payload is fields, not ids, since no other rank
     holds this shard's parameters;
  4. exchange the windows with one ``all_to_all_single`` inside an
     autograd Function whose backward is the reverse exchange, so each
     slot's cotangent returns to the rank that owns its gaussian;
  5. merge the n incoming depth-sorted streams with one stable (tile,
     depth) sort, shift y into slab rows, and rasterize the slab with the
     unchanged ``rasterize_gaussians``, each received slot a
     pseudo-gaussian (B5, B1, and in the backward B2 and B3 with the gather
     adjoint into the pseudo-gaussians).

Each rank's gradients come out as its own shard's: the local loss is
differentiated, and the reverse exchange carries every slab's share back.
Only the scalar loss and the counters cross the mesh besides the slots.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.distributed as dist

from ..camera import Camera
from ..config import DEFAULT_CONFIG, RenderConfig
from ..ops.binning import BinningAux, BinningResult, bin_gaussians_to_tiles, isect_capacity
from ..ops.binning import num_tiles
from ..ops.projection import project_gaussians
from ..ops.rasterization import rasterize_gaussians
from ..ops.sh import sh_to_color
from ..params import activate
from .sharding import Mesh, _new_mesh, all_gather_parts, all_to_all


class RouteAux(NamedTuple):
    """Counters of the routed pipeline (int32 scalars, summed over the
    mesh)."""

    num_isects: torch.Tensor  # slots routed and rasterized
    capacity_overflow: torch.Tensor  # dropped by per-shard binning capacity
    span_truncated: torch.Tensor  # tile slots lost to the per-gaussian span cap
    route_overflow: torch.Tensor  # dropped by the per-(source, destination) window
    tile_overflow: torch.Tensor  # dropped by the per-tile capacity at the receiver


def make_gauss_mesh(n_devices: int, device=None) -> Mesh:
    """A 1-D (``"gauss"``,) mesh over the first n_devices ranks: the rank at
    index i owns the i-th parameter shard and the i-th tile-row slab.
    Every rank of the world calls it."""
    return _new_mesh({"gauss": n_devices}, device)


def route_pair_capacity(n_local: int, n_dev: int, config: RenderConfig) -> int:
    """The slots each (source, destination) window holds: twice a balanced
    scene's share of the local capacity (room for skew before
    ``route_overflow`` counts drops), rounded up to 128."""
    cap = isect_capacity(n_local, config)
    per = 2 * cap // max(n_dev, 1)
    return max(128, -(-per // 128) * 128)


def check_gauss_slabs(H: int, n_dev: int, config: RenderConfig) -> int:
    """The slab height H / n_dev; raises unless the slabs are whole tile
    rows (binning against global tiles while rasterizing misaligned slabs
    would train on the wrong pixels)."""
    if H % (n_dev * config.tile_size) != 0:
        raise ValueError(
            f"image height {H} must divide into {n_dev} slabs of "
            f"whole {config.tile_size}-px tile rows"
        )
    return H // n_dev


def _route_slots(params, camera: Camera, sh_degree, config: RenderConfig, mesh: Mesh):
    """Steps 1-4: project and bin the local shard, send each slot's fields
    to the owner of its tile.

    Returns (fields (M, R) row-major, ltile (M,), depth (M,), counters),
    the M = n_dev * cap_pair received slots: blend fields [x, y, conic(3),
    opacity, colour(C)], the slab-local tile id (the slab's tile count on
    padding) and the depth."""
    means3d = params["means3d"]
    features = params["features"]
    n_local = means3d.shape[0]
    n_dev = mesh.shape["gauss"]
    H, W = camera.H, camera.W
    th, tw = num_tiles(H, W, config.tile_size)
    n_tiles = th * tw
    if th % n_dev != 0:
        raise ValueError(f"tile rows ({th}) must divide evenly over the gauss axis ({n_dev})")
    tiles_per_slab = (th // n_dev) * tw
    dev = means3d.device

    colors = features if sh_degree is None else sh_to_color(
        features, means3d, camera.position, sh_degree)
    proj = project_gaussians(means3d, params["scales"], params["quats"], params["opacities"],
                             camera, config)
    opacities = params["opacities"]
    if config.antialiased:
        opacities = opacities * proj.compensations
    binning = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, H, W, config,
                                     conics=proj.conics, opacities=opacities)

    gids = binning.gaussian_ids
    valid = gids >= 0
    # Every gather below reads padding through rows spread over the source
    # (the values are masked to zero): the gathers' backward adds with
    # atomics, and millions of padding slots on one row would serialise.
    spread = torch.arange(gids.shape[0], device=dev)
    safe = torch.where(valid, gids.to(torch.int64), spread % max(n_local, 1))
    fields_n = torch.cat([proj.means2d, proj.conics, opacities[:, None], colors],
                         dim=1).to(torch.float32)  # (n_local, R)
    slot_fields = torch.where(valid[:, None], fields_n[safe], 0.0)  # (cap_local, R)
    slot_depth = torch.where(valid, proj.depths.detach()[safe], torch.inf)
    slot_tile = binning.tile_ids  # sorted; n_tiles on padding

    # Each destination's slots are one contiguous run of the sorted list.
    bounds = torch.searchsorted(
        slot_tile, torch.arange(n_dev + 1, dtype=torch.int32, device=dev) * tiles_per_slab,
        out_int32=True)
    counts = bounds[1:] - bounds[:-1]
    cap_pair = route_pair_capacity(n_local, n_dev, config)
    route_overflow = torch.clamp(counts - cap_pair, min=0).sum()

    j = torch.arange(cap_pair, dtype=torch.int32, device=dev)
    in_win = (j[None, :] < torch.clamp(counts, max=cap_pair)[:, None]).reshape(-1)
    idx = (bounds[:-1, None] + j[None, :]).reshape(-1).to(torch.int64)  # (n_dev * cap_pair,)
    idx = torch.where(in_win, idx, torch.arange(idx.shape[0], device=dev) % slot_tile.shape[0])
    w_fields = torch.where(in_win[:, None], slot_fields[idx], 0.0)
    w_tile = torch.where(in_win, slot_tile[idx], n_tiles).to(torch.int32)
    w_depth = torch.where(in_win, slot_depth[idx], torch.inf).to(torch.float32)

    # Window d goes to rank d; block s of what arrives came from rank s.
    group = mesh.group
    r_fields = all_to_all(w_fields, group)
    meta = torch.empty((w_tile.shape[0], 2), dtype=torch.int32, device=dev)
    dist.all_to_all_single(meta, torch.stack([w_tile, w_depth.view(torch.int32)], dim=1),
                           group=group)
    r_tile, r_depth = meta[:, 0], meta[:, 1].view(torch.float32)

    # Global -> slab-local tile ids; what is not in this slab (padding only,
    # by construction) goes to the local sentinel.
    lt = r_tile - mesh.index("gauss") * tiles_per_slab
    ltile = torch.where((lt >= 0) & (lt < tiles_per_slab), lt, tiles_per_slab)
    counters = RouteAux(
        num_isects=(ltile < tiles_per_slab).sum().to(torch.int32),
        capacity_overflow=binning.aux.capacity_overflow,
        span_truncated=binning.aux.span_truncated,
        route_overflow=route_overflow.to(torch.int32),
        tile_overflow=torch.zeros((), dtype=torch.int32, device=dev),  # the rasterizer's
    )
    return r_fields, ltile, r_depth, counters


def _rasterize_routed(fields, ltile, depth, camera: Camera, slab_h: int, config: RenderConfig,
                      background, C: int):
    """Step 5: merge the received streams and rasterize this rank's slab.

    One stable (tile, depth) sort merges the depth-sorted source streams
    (ties keep the arrival order, source by source); the sorted slots'
    fields and an identity id list form the pseudo-gaussian scene the
    unchanged rasterizer takes."""
    M = fields.shape[0]
    th_l, tw = num_tiles(slab_h, camera.W, config.tile_size)
    by_depth = torch.sort(depth, stable=True).indices
    by_tile = torch.sort(ltile[by_depth], stable=True).indices
    perm = by_depth[by_tile]
    lt_sorted = ltile[perm].contiguous()
    fields_s = fields[perm]

    dev = fields.device
    boundaries = torch.searchsorted(
        lt_sorted, torch.arange(th_l * tw + 1, dtype=torch.int32, device=dev), out_int32=True)
    tile_ranges = torch.stack([boundaries[:-1], boundaries[1:]], dim=-1).reshape(th_l, tw, 2)
    pad = lt_sorted >= th_l * tw
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pseudo = BinningResult(
        gaussian_ids=torch.where(pad, -1, torch.arange(M, dtype=torch.int32, device=dev)),
        tile_ids=lt_sorted,
        tile_ranges=tile_ranges,
        aux=BinningAux(num_isects=boundaries[-1], capacity_overflow=zero,
                       span_truncated=zero, tight_culled=zero),
    )
    return rasterize_gaussians(
        fields_s[:, 0:2], fields_s[:, 2:5], fields_s[:, 6:6 + C], fields_s[:, 5],
        background, pseudo, slab_h, camera.W, config)


def _render_slab(params, camera: Camera, sh_degree, config: RenderConfig, background,
                 mesh: Mesh, slab_h: int):
    """Route and rasterize: this rank's (slab_h, W, C) slab and the
    mesh-summed counters."""
    C = params["features"].shape[-1]  # (N, C) RGB or (N, K, C) SH
    fields, ltile, depth, counters = _route_slots(params, camera, sh_degree, config, mesh)
    if background is None:
        bg = torch.zeros((C,), dtype=torch.float32, device=fields.device)
    else:
        bg = torch.as_tensor(background, dtype=torch.float32, device=fields.device)
    # The routed centres are image coordinates; the receiver rasterizes a
    # slab whose rows start at 0 (render_gaussians' viewport_rows shift).
    row0 = float(mesh.index("gauss") * slab_h)
    shift = torch.zeros((fields.shape[1],), dtype=fields.dtype, device=fields.device)
    shift[1] = row0
    image, raster_aux = _rasterize_routed(fields - shift, ltile, depth, camera, slab_h, config,
                                          bg, C)
    counters = counters._replace(tile_overflow=raster_aux.tile_overflow.to(torch.int32))
    summed = torch.stack([c.to(torch.int64) for c in counters])
    dist.all_reduce(summed, group=mesh.group)
    return image, RouteAux(*(c.to(torch.int32) for c in summed))


def render_gaussians_sharded(
    params: Mapping[str, torch.Tensor],  # activated; this rank's shard of rows
    camera: Camera,
    mesh: Mesh,
    sh_degree: int | None = None,
    background_color=None,
    config: RenderConfig = DEFAULT_CONFIG,
    return_aux: bool = False,
):
    """Render with the gaussians and the tile rows split over a
    (``"gauss"``,) mesh. ``params``: this rank's contiguous shard of the
    activated parameters (``convert.shard_from_numpy`` cuts one). Returns
    this rank's (H / n, W, C) slab (``gather_slabs`` assembles the image)
    and, with ``return_aux``, the mesh-summed ``RouteAux``."""
    slab_h = check_gauss_slabs(camera.H, mesh.shape["gauss"], config)
    image, counters = _render_slab(params, camera, sh_degree, config, background_color, mesh,
                                   slab_h)
    return (image, counters) if return_aux else image


def gather_slabs(slab: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full image from every rank's slab, on every rank of the mesh."""
    return torch.cat(all_gather_parts(slab, mesh.group))


def train_step_gauss_sharded(
    params: Mapping[str, torch.Tensor],  # raw leaves: this rank's shard
    optimizer: torch.optim.Optimizer,  # over this rank's shard (its moments are its own)
    camera: Camera,
    target: torch.Tensor,  # (H / n, W, C): this rank's slab of the target
    mesh: Mesh,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """One fully sharded training step (ZeRO-3 over the ``"gauss"`` axis).

    Parameters, gradients and optimizer moments stay this rank's shard: the
    backward of the routed render hands each rank exactly its own rows'
    gradients (the all-to-all's reverse exchange; no all-reduce of
    parameter gradients), and the optimizer steps locally. The local loss,
    ``sum((slab - target)^2) / (the image's element count)``, is not
    reduced inside the differentiated function; only its value is summed
    over the mesh. Returns the global loss (detached)."""
    n_dev = mesh.shape["gauss"]
    slab_h = check_gauss_slabs(camera.H, n_dev, config)
    denom = float(target.numel() * n_dev)
    optimizer.zero_grad(set_to_none=True)
    image, _ = _render_slab(activate(params), camera, sh_degree, config, None, mesh, slab_h)
    local = torch.sum((image - target) ** 2) / denom
    local.backward()
    optimizer.step()
    loss = local.detach().clone()
    dist.all_reduce(loss, group=mesh.group)
    return loss
