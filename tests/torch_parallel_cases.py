"""Worlds of processes for the port's parallel/ tests (a helper module, no
tests, no JAX).

``run_world(case, n, tmp)`` starts n processes of this file, each one rank
of a gloo world on the CPU (configured through the MOJOSPLAT_* variables,
so ``init_multihost``'s explicit branch runs), waits for them, fails with
a rank's output if one fails, and returns each rank's saved arrays. Each
rank calls ``torch.set_num_threads(1)``, so a world does not starve the
other test workers. The case functions below build their inputs from
seeded numpy (``cameras_np``, ``gaussians_np``, ``surfels_np``), which the
tests rebuild for the JAX side.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TIMEOUT_S = 120


# ---- Inputs, numpy only


def cameras_np(B: int, H: int = 64, W: int = 64, fx: float = 80.0, seed: int = 0) -> list:
    """B pinhole cameras with small random rotations about y and
    translations (tests/test_sharding.py's batched_cameras), as field
    dicts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        a = rng.normal(0, 0.05)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        T = rng.normal(0, 0.05, 3).astype(np.float32)
        out.append(dict(R=R, T=T, H=H, W=W, fx=fx, fy=fx, cx=W / 2, cy=H / 2, near=0.1,
                        far=100.0))
    return out


def gaussians_np(n: int, seed: int = 0, sh_degree: int | None = None, z: float = 2.5,
                 spread: float = 0.5) -> dict:
    """Raw 3DGS parameters in front of the cameras: centres N(0, spread)
    about (0, 0, z), log-scales about -2.5, unit quaternions, logits about
    1, colours in [0, 1) (or SH bands with a band-0 colour)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, spread, (n, 3)) + np.array([0.0, 0.0, z])
    q = rng.normal(0, 1, (n, 4))
    out = dict(
        means3d=means,
        scales=rng.normal(-2.5, 0.3, (n, 3)),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True),
        opacities_raw=rng.normal(1.0, 0.5, n),
    )
    if sh_degree is None:
        out["features"] = rng.uniform(0, 1, (n, 3))
    else:
        k = (sh_degree + 1) ** 2
        f = rng.normal(0, 0.1, (n, k, 3))
        f[:, 0] = rng.uniform(-0.5, 0.5, (n, 3))
        out["features"] = f
    return {k: v.astype(np.float32) for k, v in out.items()}


def surfels_np(n: int, seed: int) -> dict:
    """Raw surfel parameters (tests/test_sharding.py's disks)."""
    rng = np.random.default_rng(seed)
    out = dict(
        means3d=np.concatenate([rng.normal(0, 0.3, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))],
                               axis=1),
        scales=rng.normal(-1.8, 0.2, (n, 2)),
        quats=rng.normal(0, 1, (n, 4)),
        opacities_raw=rng.normal(1.0, 0.5, n),
        features=rng.uniform(0, 1, (n, 3)),
    )
    return {k: v.astype(np.float32) for k, v in out.items()}


# The sharded surfel world's views and targets (its golden's inputs).
SURFEL_H = 128
SURFEL_WEIGHTS = dict(normal_weight=0.05, distortion_weight=0.01)


def surfel_targets_np() -> np.ndarray:
    return np.random.default_rng(21).uniform(0, 1, (2, SURFEL_H, 64, 3)).astype(np.float32)


def surfel_golden_digest() -> str:
    """SHA-256 of the sharded surfel world's inputs: the disks, the views,
    the targets, the render config and the loss weights.
    tests/golden/sharded_surfel.npz stores the digest of the inputs it was
    written from."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(surfels_np(48, 21).items()):
        h.update(k.encode() + v.tobytes())
    for cam in cameras_np(2, H=SURFEL_H, seed=0):
        for k, v in sorted(cam.items()):
            h.update(k.encode() + np.asarray(v).tobytes())
    h.update(surfel_targets_np().tobytes())
    h.update(repr(sorted(CFG.items())).encode() + repr(sorted(SURFEL_WEIGHTS.items())).encode())
    return h.hexdigest()


def skewed_gaussians_np(n: int, seed: int) -> dict:
    """tests/test_gauss_sharded.py's skewed scene: small splats stacked
    about one spot of one slab, so every shard sends its slots to one
    destination."""
    raw = gaussians_np(n, seed, z=0.0, spread=1.0)
    raw["means3d"] = (np.array([0.0, -0.35, 2.0], np.float32)
                      + 0.02 * raw["means3d"]).astype(np.float32)
    raw["scales"] = np.full((n, 3), np.log(0.05), np.float32)
    return raw


# ---- Worlds


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(case: str, n: int, out: Path, args: list[str] = ()) -> list:
    """Start the n ranks of ``case`` (their results go under ``out``);
    returns the processes. ``finish_world`` waits for them."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env.update(MOJOSPLAT_COORDINATOR=f"127.0.0.1:{free_port()}",
               MOJOSPLAT_NUM_PROCESSES=str(n), OMP_NUM_THREADS="1")
    procs = []
    for r in range(n):
        env_r = dict(env, MOJOSPLAT_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__)), case, str(out), *args], env=env_r,
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_world(procs: list, out: Path) -> list[dict]:
    """Wait for the ranks; raise with a failed rank's output; return each
    rank's saved arrays."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} failed (rc={p.returncode}):\n{text[-4000:]}")
    results = []
    for r in range(len(procs)):
        with np.load(out / f"rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


def run_world(case: str, n: int, out: Path, args: list[str] = ()) -> list[dict]:
    return finish_world(start_world(case, n, out, args), out)


# ---- The cases, run in each rank


CFG = dict(tile_capacity=64, chunk_size=32)
MESHES = ((1, 2), (2, 1), (2, 2))


def _np(x):
    return x.detach().cpu().numpy()


def case_sharding(out: dict, rank: int) -> None:
    """The camera-DP x tile-SP 3DGS path in a world of 4."""
    import torch

    from mojosplat_tpu_torch import RenderConfig
    from mojosplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
    from mojosplat_tpu_torch.densify import mcmc_regularization
    from mojosplat_tpu_torch.parallel import make_mesh, project_gaussians_sharded
    from mojosplat_tpu_torch.parallel import render_batch_sharded
    from mojosplat_tpu_torch.parallel.sharding import batch_block, gather_batch
    from mojosplat_tpu_torch.train import (
        activate, make_optimizer, train_step_sharded, train_step_sharded_surfel, zero1_rows)

    cpu = torch.device("cpu")
    cfg = RenderConfig(**CFG)
    cams = [camera_from_numpy(c, cpu) for c in cameras_np(2, seed=0)]
    raw = gaussians_np(48, seed=1)
    params = activate(params_from_numpy(raw, cpu))

    # Renders: each rank's block and the gathered batch, on both routes.
    for nd, nt in MESHES:
        mesh = make_mesh(nd, nt, device=cpu)
        if mesh.rank is None:
            continue
        for impl in ("torch", "cuda"):
            if impl == "cuda" and (nd, nt) != (2, 2):
                continue
            c = RenderConfig(raster_impl=impl, **CFG)
            with torch.no_grad():
                block = render_batch_sharded(params, cams, mesh, config=c)
            out[f"block_{impl}_{nd}x{nt}"] = _np(block)
            out[f"full_{impl}_{nd}x{nt}"] = _np(gather_batch(block, mesh))

    # The projection over the gaussians' rows, along the tile axis of (1, 4).
    mesh = make_mesh(1, 4, device=cpu)
    raw64 = gaussians_np(64, seed=2)
    p64 = activate(params_from_numpy(raw64, cpu))
    with torch.no_grad():
        res = project_gaussians_sharded(p64["means3d"], p64["scales"], p64["quats"],
                                        p64["opacities"], cams[0], mesh, config=cfg)
    for k, v in res._asdict().items():
        out[f"proj_{k}"] = _np(v)

    # One SGD step at lr 1 (the parameter change is the gradient) on each
    # mesh, and with the MCMC regulariser on (2, 2).
    targets = torch.from_numpy(
        np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    for (nd, nt), extra in zip(MESHES + ((2, 2),), (False, False, False, True)):
        mesh = make_mesh(nd, nt, device=cpu)
        if mesh.rank is None:
            continue
        leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw, cpu).items()}
        opt = torch.optim.SGD(list(leaves.values()), lr=1.0)
        loss = train_step_sharded(
            leaves, opt, cams, batch_block(targets, mesh), mesh, config=cfg,
            loss_extra=(lambda p: mcmc_regularization(p)) if extra else None)
        tag = f"sgd{'_mcmc' if extra else ''}_{nd}x{nt}"
        out[f"{tag}_loss"] = _np(loss)
        for k, v in leaves.items():
            out[f"{tag}_{k}"] = _np(v)

    # ZeRO-1 against the replicated update: two Adam steps each.
    mesh = make_mesh(2, 2, device=cpu)
    raw64z = gaussians_np(64, seed=5)
    tz = torch.from_numpy(
        np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    for z in (False, True):
        leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw64z, cpu).items()}
        shards = zero1_rows(leaves, mesh) if z else None
        if z:
            from mojosplat_tpu_torch.convert import shard_from_numpy

            want = shard_from_numpy(raw64z, mesh.rank, mesh.size, cpu)
            for k in want:
                assert torch.equal(shards[k], want[k]), k
        opt = make_optimizer(shards if z else leaves, lr=1e-2)
        for _ in range(2):
            loss = train_step_sharded(leaves, opt, cams, batch_block(tz, mesh), mesh,
                                      config=cfg, zero1=shards)
        out[f"zero1_{z}_loss"] = _np(loss)
        for k, v in leaves.items():
            out[f"zero1_{z}_{k}"] = _np(v)
        if z:
            out["zero1_moment_rows"] = np.array(
                opt.state[shards["means3d"]]["exp_avg"].shape[0])

    # The refusals: slabs of a 48-row view on 4 tile ranks, a mesh larger
    # than the world, ZeRO-1 rows that do not split.
    errors = []
    mesh14 = make_mesh(1, 4, cpu)
    cam48 = [camera_from_numpy(cameras_np(1, H=48)[0], cpu)]
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw, cpu).items()}
    opt = torch.optim.SGD(list(leaves.values()), lr=1.0)
    t48 = torch.zeros((1, 12, 64, 3))
    for fn in (
        lambda: render_batch_sharded(params, cam48, mesh14, config=cfg),
        lambda: train_step_sharded(leaves, opt, cam48, t48, mesh14, config=cfg),
        lambda: train_step_sharded_surfel(leaves, opt, cam48, t48, mesh14, config=cfg),
        lambda: make_mesh(4, 2, cpu),
        lambda: zero1_rows({"x": torch.zeros(6)}, make_mesh(2, 2, cpu)),
    ):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)


def case_surfel(out: dict, rank: int) -> None:
    """The sharded 2DGS render and training step in a world of 4."""
    import torch

    from mojosplat_tpu_torch import RenderConfig
    from mojosplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
    from mojosplat_tpu_torch.parallel import make_mesh, render_batch_sharded
    from mojosplat_tpu_torch.parallel.sharding import batch_block
    from mojosplat_tpu_torch.train import (
        activate, make_optimizer, train_step_sharded_surfel, zero1_rows)

    cpu = torch.device("cpu")
    cfg = RenderConfig(**CFG)
    cams = [camera_from_numpy(c, cpu) for c in cameras_np(2, H=SURFEL_H, seed=0)]

    mesh22 = make_mesh(2, 2, device=cpu)
    raw = surfels_np(48, 21)
    p = activate(params_from_numpy(raw, cpu))
    for impl in ("torch", "cuda"):
        with torch.no_grad():
            block = render_batch_sharded(p, cams, mesh22, primitive="2dgs",
                                         config=RenderConfig(raster_impl=impl, **CFG))
        out[f"block_{impl}"] = _np(block)

    targets = torch.from_numpy(surfel_targets_np())
    weights = SURFEL_WEIGHTS
    for nd, nt in ((1, 2), (2, 2)):
        mesh = make_mesh(nd, nt, device=cpu)
        if mesh.rank is None:
            continue
        leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw, cpu).items()}
        opt = torch.optim.SGD(list(leaves.values()), lr=1.0)
        loss = train_step_sharded_surfel(leaves, opt, cams, batch_block(targets, mesh), mesh,
                                         config=cfg, **weights)
        out[f"sgd_{nd}x{nt}_loss"] = _np(loss)
        for k, v in leaves.items():
            out[f"sgd_{nd}x{nt}_{k}"] = _np(v)

    raw64 = surfels_np(64, 31)
    t31 = torch.from_numpy(
        np.random.default_rng(31).uniform(0, 1, (2, 128, 64, 3)).astype(np.float32))
    for z in (False, True):
        leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw64, cpu).items()}
        shards = zero1_rows(leaves, mesh22) if z else None
        opt = make_optimizer(shards if z else leaves, lr=1e-2)
        loss = train_step_sharded_surfel(leaves, opt, cams, batch_block(t31, mesh22), mesh22,
                                         config=cfg, zero1=shards, **weights)
        out[f"zero1_{z}_loss"] = _np(loss)
        for k, v in leaves.items():
            out[f"zero1_{z}_{k}"] = _np(v)


GAUSS_H, GAUSS_W = 128, 64  # 8 tile rows: 4 or 2 a slab
GAUSS_CFG = dict(tile_capacity=64, chunk_size=32, max_tile_span=4)
GAUSS_BG = (0.2, 0.1, 0.0)


def gauss_target_np(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (GAUSS_H, GAUSS_W, 3)).astype(np.float32)


def case_gauss(out: dict, rank: int) -> None:
    """The gaussian-sharded routed pipeline in a world of 4: meshes of 2 and
    4 ranks. Scene A (RGB) renders with a background and takes the
    gradient of its mean squared error; scene B (SH degree 1) takes one
    SGD step at lr 1 through ``train_step_gauss_sharded``."""
    import torch

    from mojosplat_tpu_torch import Camera, RenderConfig
    from mojosplat_tpu_torch.convert import shard_from_numpy
    from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.parallel import (
        make_gauss_mesh, render_gaussians_sharded, train_step_gauss_sharded)
    from mojosplat_tpu_torch.parallel.gauss_sharded import gather_slabs
    from mojosplat_tpu_torch.train import activate, make_optimizer

    cpu = torch.device("cpu")
    cfg = RenderConfig(**GAUSS_CFG)
    H, W = GAUSS_H, GAUSS_W

    def camera(h=H):
        return Camera.create(R=np.eye(3), T=np.zeros(3), H=h, W=W, fx=80.0, fy=80.0,
                             cx=W / 2, cy=h / 2, device=cpu)

    tgt_a, tgt_b = gauss_target_np(9), gauss_target_np(5)
    for n_dev in (2, 4):
        mesh = make_gauss_mesh(n_dev, device=cpu)
        if mesh.rank is None:
            continue
        rows = slice(mesh.rank * H // n_dev, (mesh.rank + 1) * H // n_dev)
        for impl in ("torch", "cuda"):
            c = RenderConfig(raster_impl=impl, **GAUSS_CFG)
            tag = f"{n_dev}_{impl}"
            leaves = {k: v.requires_grad_(True) for k, v in shard_from_numpy(
                gaussians_np(64, 3), mesh.rank, n_dev, cpu).items()}
            slab, aux = render_gaussians_sharded(activate(leaves), camera(), mesh,
                                                 background_color=GAUSS_BG, config=c,
                                                 return_aux=True)
            (torch.sum((slab - torch.from_numpy(tgt_a[rows])) ** 2) / tgt_a.size).backward()
            out[f"a_{tag}_slab"] = _np(slab)
            out[f"a_{tag}_image"] = _np(gather_slabs(slab.detach(), mesh))
            out[f"a_{tag}_aux"] = np.array([int(x) for x in aux])
            for k, v in leaves.items():
                out[f"a_{tag}_grad_{k}"] = _np(v.grad)
            shard_b = activate(shard_from_numpy(gaussians_np(64, 4, 1), mesh.rank, n_dev, cpu))
            with torch.no_grad():
                out[f"b_{tag}_slab"] = _np(render_gaussians_sharded(
                    shard_b, camera(), mesh, sh_degree=1, config=c))

    # One SGD step at lr 1 of scene B on the mesh of 4.
    mesh = make_gauss_mesh(4, device=cpu)
    rows = slice(mesh.rank * H // 4, (mesh.rank + 1) * H // 4)
    leaves = {k: v.requires_grad_(True)
              for k, v in shard_from_numpy(gaussians_np(64, 4, 1), mesh.rank, 4, cpu).items()}
    opt = torch.optim.SGD(list(leaves.values()), lr=1.0)
    loss = train_step_gauss_sharded(leaves, opt, camera(), torch.from_numpy(tgt_b[rows]),
                                    mesh, sh_degree=1, config=cfg)
    out["sgd_loss"] = _np(loss)
    for k, v in leaves.items():
        out[f"sgd_{k}"] = _np(v)

    # The skewed scene: each shard's own binning (the counters' parts) and
    # the routed render's counters; then 8 Adam steps through the overflow.
    raw = skewed_gaussians_np(4096, 3)
    shard = activate(shard_from_numpy(raw, mesh.rank, 4, cpu))
    with torch.no_grad():
        proj = project_gaussians(shard["means3d"], shard["scales"], shard["quats"],
                                 shard["opacities"], camera(), cfg)
        b = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, H, W, cfg,
                                   conics=proj.conics, opacities=shard["opacities"])
        out["skew_bin_aux"] = np.array([int(x) for x in b.aux])
        _, aux = render_gaussians_sharded(shard, camera(), mesh, config=cfg, return_aux=True)
    out["skew_aux"] = np.array([int(x) for x in aux])
    target = np.tile(np.linspace(0.1, 0.9, W, dtype=np.float32)[None, :, None], (H, 1, 3))
    leaves = {k: v.requires_grad_(True)
              for k, v in shard_from_numpy(raw, mesh.rank, 4, cpu).items()}
    opt = make_optimizer(leaves, lr=5e-2)
    losses = []
    for _ in range(8):
        losses.append(float(train_step_gauss_sharded(
            leaves, opt, camera(), torch.from_numpy(target[rows]), mesh, config=cfg)))
    out["skew_losses"] = np.array(losses)
    with torch.no_grad():
        _, aux = render_gaussians_sharded(activate(leaves), camera(), mesh, config=cfg,
                                          return_aux=True)
    out["skew_trained_aux"] = np.array([int(x) for x in aux])
    out["skew_finite"] = np.array(all(bool(torch.isfinite(v).all()) for v in leaves.values()))

    errors = []
    for fn in (
        lambda: render_gaussians_sharded(shard, camera(48), mesh, config=cfg),
        lambda: train_step_gauss_sharded(leaves, opt, camera(48),
                                         torch.zeros((12, W, 3)), mesh, config=cfg),
    ):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)


def case_allreduce(out: dict, rank: int) -> None:
    """tests/test_multihost_smoke.py's check: each rank adds rank + 1."""
    import torch
    import torch.distributed as dist

    from mojosplat_tpu_torch.parallel import is_primary

    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    out["sum"] = x.numpy()
    out["world"] = np.array(dist.get_world_size())
    out["primary"] = np.array(is_primary())


CASES = {"sharding": case_sharding, "surfel": case_surfel, "gauss": case_gauss,
         "allreduce": case_allreduce}


def main() -> None:
    case, out_dir = sys.argv[1], Path(sys.argv[2])
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from mojosplat_tpu_torch.parallel import init_multihost

    torch.set_num_threads(1)
    if not init_multihost(backend="gloo"):
        raise SystemExit("the MOJOSPLAT_* variables are not set")
    rank = dist.get_rank()
    out: dict = {}
    try:
        CASES[case](out, rank)
        np.savez(out_dir / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
