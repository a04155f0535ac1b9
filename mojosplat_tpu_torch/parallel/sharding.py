"""Camera-DP x tile-row-SP over a mesh of ``torch.distributed`` ranks.

Counterpart of ``mojosplat_tpu.parallel.sharding``. One process runs per
rank; a ``Mesh`` names the ranks of a (``"data"``, ``"tile"``) grid (or the
one ``"gauss"`` axis of ``gauss_sharded``), row-major: the rank at data
index ``d`` and tile index ``t`` is ``d * n_tile + t``. It holds a process
group for the whole mesh and one along each axis through this rank.

  - **Camera parallelism** (``"data"``): a batch of B cameras is split
    into n_data blocks of B / n_data, one per data index.
  - **Tile-row parallelism** (``"tile"``): each rank renders the
    horizontal slab of ``H / n_tile`` rows at its tile index with
    ``render_gaussians(viewport_rows=...)`` (or ``render_surfels``).
    Projection is the full camera's on every rank, so conics and culling
    are those of the single-device render; only binning and blending are
    cut to the slab.
  - **Gaussian rows** (``project_gaussians_sharded``): each rank projects
    its N / n rows and an all-gather assembles the result.

A rank's output is its block: ``(B / n_data, H / n_tile, W, C)`` images of
its cameras' slab. ``gather_batch`` assembles the full batch on every
rank; ``batch_block`` cuts a rank's block from a full one.

Collectives that autograd differentiates through are small
``torch.autograd.Function``s with the transposes the reference's
``shard_map`` (with ``check_vma=False``) takes: an all-reduce's backward
all-reduces the cotangent, a row all-gather's backward all-reduces it and
keeps this rank's rows, and an all-to-all's backward is the reverse
all-to-all. Collectives run on their tensors' device: CUDA tensors for an
NCCL group, CPU tensors (or, on the card, CUDA ones) for a gloo group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from ..camera import Camera
from ..config import DEFAULT_CONFIG, RenderConfig
from ..ops.projection import ProjectionResult, project_gaussians
from ..render import render_gaussians
from ..surfel import render_surfels


@dataclass(frozen=True)
class Mesh:
    """The ranks of a named grid and this rank's place in it.

    ``shape``: axis name -> size, in axis order. ``rank``: this process's
    index in the mesh (row-major over the axes), None when the process is
    not one of its ranks (``make_mesh`` over fewer ranks than the world).
    ``group``: the process group of every rank of the mesh;
    ``axis_groups``: this rank's group along each axis. The sharded
    functions run on their tensors' device."""

    shape: dict
    rank: int | None
    group: Any
    axis_groups: dict

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        names = list(self.shape)
        stride = 1
        for name in names[names.index(axis) + 1:]:
            stride *= self.shape[name]
        return (self.rank // stride) % self.shape[axis]


def _new_mesh(axes: Mapping[str, int], device) -> Mesh:
    """Build a Mesh over the first prod(axes) ranks of the default group.

    Every rank of the world must call it (``new_group`` is collective),
    also the ranks the mesh leaves out."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_multihost (or "
                           "torch.distributed.init_process_group) first")
    shape = dict(axes)
    need = 1
    for v in shape.values():
        need *= v
    world = dist.get_world_size()
    if world < need:
        raise ValueError(f"need {need} ranks, have {world}")
    _check_device(device)
    me = dist.get_rank()
    rank = me if me < need else None
    group = dist.new_group(list(range(need)))
    names = list(shape)
    axis_groups = {}
    for a, name in enumerate(names):
        stride = 1
        for other in names[a + 1:]:
            stride *= shape[other]
        # Every line of ranks along this axis, in a fixed order on every
        # rank; keep the one through this rank.
        for base in range(need):
            if (base // stride) % shape[name]:
                continue
            members = [base + i * stride for i in range(shape[name])]
            g = dist.new_group(members)
            if rank is not None and rank in members:
                axis_groups[name] = g
    return Mesh(shape, rank, group, axis_groups)


def _check_device(device) -> None:
    """Raise unless the mesh's ranks can run where asked: the card when
    ``device`` is None, else ``device``."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("the sharded paths run on the card unless a CPU device is "
                           "passed; no CUDA device is available")


def make_mesh(n_data: int, n_tile: int, device=None) -> Mesh:
    """A (``"data"``, ``"tile"``) mesh over the first n_data * n_tile ranks
    of the default group. ``device``: None for the card (it raises when
    there is none), or the CPU for a gloo group; the sharded functions run
    on their tensors' device. Every rank of the world calls it."""
    return _new_mesh({"data": n_data, "tile": n_tile}, device)


def check_slab_divisibility(H: int, n_tile: int, config: RenderConfig) -> int:
    """The slab height H / n_tile; raises unless it is whole tile rows."""
    ts = config.tile_size
    if H % (n_tile * ts) != 0:
        raise ValueError(
            f"image height {H} must be divisible by tile-axis size {n_tile} "
            f"x tile_size {ts}"
        )
    return H // n_tile


# ---- Collectives with their transposes


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents (the
    reference's psum transpose with check_vma=False)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        out = ct.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGatherRows(torch.autograd.Function):
    """Concatenate every rank's rows in group order; the backward sums the
    cotangents over the group and keeps this rank's rows (the reference's
    all_gather transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        return torch.cat(all_gather_parts(x, group))

    @staticmethod
    def backward(ctx, ct):
        summed = ct.contiguous().clone()
        dist.all_reduce(summed, group=ctx.group)
        return summed[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all over the leading axis: block d of this rank
    goes to rank d, and block s of the output came from rank s. Its
    backward is the same exchange of the cotangents, back to the sender."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        out = torch.empty_like(ct)
        dist.all_to_all_single(out, ct.contiguous(), group=ctx.group)
        return out, None


def all_gather_parts(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` in group order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return _AllGatherRows.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return _AllToAll.apply(x, group)


# ---- Blocks of a batch


def local_cameras(cameras: Sequence[Camera], mesh: Mesh) -> list[Camera]:
    """This rank's block of the global camera batch (its data index's
    B / n_data cameras)."""
    n_data = mesh.shape["data"]
    if len(cameras) % n_data:
        raise ValueError(f"{len(cameras)} cameras do not split over {n_data} data ranks")
    b = len(cameras) // n_data
    d = mesh.index("data")
    return list(cameras[d * b:(d + 1) * b])


def batch_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a full (B, H, W, ...) batch: its data index's
    B / n_data views, rows of its tile index's slab."""
    b = x.shape[0] // mesh.shape["data"]
    h = x.shape[1] // mesh.shape["tile"]
    d, t = mesh.index("data"), mesh.index("tile")
    return x[d * b:(d + 1) * b, t * h:(t + 1) * h]


def gather_batch(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full (B, H, W, ...) batch from every rank's block, on every
    rank of the mesh."""
    parts = all_gather_parts(block, mesh.group)
    n_tile = mesh.shape["tile"]
    rows = [torch.cat(parts[d * n_tile:(d + 1) * n_tile], dim=1)
            for d in range(mesh.shape["data"])]
    return torch.cat(rows, dim=0)


# ---- Rendering and projection


def render_slabs(
    params: Mapping[str, torch.Tensor],
    cameras: Sequence[Camera],
    row0: int,
    slab_h: int,
    sh_degree: int | None,
    background_color,
    config: RenderConfig,
    primitive: str = "3dgs",
    **render_kwargs,
):
    """This rank's slab of rows ``[row0, row0 + slab_h)`` of each of its
    ``cameras``: a (B_local, slab_h, W, C) stack, or with extra outputs
    (``render_kwargs`` such as ``return_aux``) the list of per-camera
    results. ``primitive``: ``"3dgs"`` (``render_gaussians``) or
    ``"2dgs"`` (``render_surfels``), which share the slab contract."""
    if primitive == "3dgs":
        render = render_gaussians
    elif primitive == "2dgs":
        render = render_surfels
    else:
        raise ValueError(f"Unknown primitive: {primitive!r}")
    outs = [
        render(params["means3d"], params["scales"], params["quats"], params["opacities"],
               params["features"], cam, sh_degree=sh_degree,
               background_color=background_color, config=config,
               viewport_rows=(row0, slab_h), **render_kwargs)
        for cam in cameras
    ]
    return outs if render_kwargs else torch.stack(outs)


def render_batch_sharded(
    params: Mapping[str, torch.Tensor],
    cameras: Sequence[Camera],
    mesh: Mesh,
    sh_degree: int | None = None,
    background_color=None,
    config: RenderConfig = DEFAULT_CONFIG,
    primitive: str = "3dgs",
) -> torch.Tensor:
    """Render the global batch of B ``cameras`` (the same list on every
    rank) over the mesh; returns this rank's (B / n_data, H / n_tile, W, C)
    block (``gather_batch`` assembles the full batch)."""
    slab_h = check_slab_divisibility(cameras[0].H, mesh.shape["tile"], config)
    return render_slabs(params, local_cameras(cameras, mesh), mesh.index("tile") * slab_h,
                        slab_h, sh_degree, background_color, config, primitive)


def project_gaussians_sharded(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    camera: Camera,
    mesh: Mesh,
    axis: str = "tile",
    config: RenderConfig = DEFAULT_CONFIG,
) -> ProjectionResult:
    """Projection split over the N gaussians along a mesh axis: each rank
    projects its N / n rows of the (full) inputs and the compact outputs are
    all-gathered along the axis. The gather's backward hands each rank its
    rows of the summed cotangent."""
    n = mesh.shape[axis]
    N = means3d.shape[0]
    if N % n != 0:
        raise ValueError(f"N={N} must be divisible by {axis} axis ({n})")
    m = N // n
    rows = slice(mesh.index(axis) * m, (mesh.index(axis) + 1) * m)
    res = project_gaussians(means3d[rows], scales[rows], quats[rows], opacities[rows], camera,
                            config)
    return ProjectionResult(*(all_gather_rows(x, mesh.axis_groups[axis]) for x in res))

