#!/usr/bin/env python3
"""Drive the PyTorch port's render and training paths once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero without printing the final result line:

  1. Device: requires CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmuls and convolutions.
  2. Build: compiles the kernels under mojosplat_tpu_torch/csrc/ with nvcc
     for sm_90a and prints the build time and ptxas register report.
  3. Golden: renders tests/golden/render_3dgs.npz's inputs on the "cuda"
     route and holds image and depth to the committed vectors
     (rtol 5e-5, atol 5e-6).
  4. Kernels: at the trained scene's own shapes (inputs from one "torch"
     route binning), each kernel against its plain PyTorch version on the
     card: B4 and B5 exactly equal; B1 within 1e-5 on at least 99.99% of
     pixel-channels and within 5e-3 everywhere, and bit-equal with and
     without its backward residual; B2 (with a seeded output cotangent)
     within 1e-4 of each gradient row's scale on at least 99.999% of values
     and within 1e-3 of it everywhere; B3 on the route's real sorted keys
     (the slot ids, dropped past each tile's count) within rtol 1e-5 of
     index_add_. B2 and B3 must be bitwise equal
     across two runs. Times each with CUDA events (median of 20 runs after
     3 warm-ups; 3 runs after 1 for B2's plain version), the least time
     the card could take (bound), and one PyTorch call computing the same
     function where there is one (library).
  5. Render: the trained 1M-gaussian scene (assets/trained_scene_1m.npz)
     at 1920x1080 with tile_size 32, max_tile_span 4, 8x intersection
     capacity and tile_capacity 512, on the "cuda" route under no_grad.
     Checks a finite image, that B1, B4 and B5 were launched during that
     render and no backward kernel or residual, and agreement with the
     "torch" route by the B1 rule; prints the drop counters, the median
     render time of 10 runs, pixels/s and peak device memory.
  6. Golden gradients: tests/test_golden.py's loss on the "cuda" route;
     every parameter's gradient against the committed vectors at
     rtol 5e-5 and atol 5e-6 x max|g|.
  7. Training: the same scene and budgets at 1920x1080, SH degree 3. The
     target is the "cuda"-route render of the scene; the raw parameters
     are perturbed by seeded numpy noise and take 10 train_steps with Adam.
     Checks a finite loss at every step and a lower loss after the last
     step than at the first, that all five kernels were launched during
     one step, bitwise-equal gradients from two backward passes on
     identical inputs, and every parameter's gradient on the "cuda" route
     against the "torch" route at a quarter of the resolution and of the
     gaussians (the B2 rule). Prints the median step time, steps/s, peak
     device memory of one step and the drop counters.

The line before the last is a JSON object with each kernel's launches in
one training step (and, for B1, B4 and B5, in the phase-5 render), its max
abs error against the plain version, its times and its bound. The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "render_3dgs.npz"
GOLDEN_RTOL, GOLDEN_ATOL = 5e-5, 5e-6
# The blend kernel multiplies T sequentially in f32 where the plain version
# takes a chunked cumprod; the ~1e-6 difference can flip the alpha-threshold
# or stop decision of a slot on a boundary pixel, so a few pixel-channels
# may differ by up to ~alpha_threshold * colour.
BLEND_ATOL, BLEND_MAX_ERR, BLEND_MAX_SHARE = 1e-5, 5e-3, 1e-4
# Gradients, per row (a pdata field, or a parameter) with scale = max |plain|:
# the f32 sums over pixels run in other orders (readings on an H100: max
# 9.8e-7 of the scale for B2, 5.2e-7 for the two routes, none over 1e-4),
# and a boundary flip like B1's would move one pixel's share of a sum.
GRAD_REL_ATOL, GRAD_MAX_REL, GRAD_MAX_SHARE = 1e-4, 1e-3, 1e-5
# Peaks of one H100 SXM (NVIDIA's H100 datasheet): HBM bytes/s
# and f32 operations/s outside the tensor cores; and the exponentials/s of
# its special-function units, 16 per clock per SM (NVIDIA's arithmetic
# throughput table for compute capability 9.0) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S, F32_OPS_PER_S, SFU_EXP_PER_S = 3.35e12, 67e12, 16 * 132 * 1.98e9
# f32 operations per (pixel, slot) pair a blend function needs, one exp
# among them: B1's alpha (15 with the exp), T update (2), weight (1) and
# 4-channel accumulate (8); B2's adjoint, the replayed alpha and T (17)
# and d alpha, the 6 geometry and 4 channel gradients and its pixel sums
# (~48). (The B2 kernel computes the alpha twice to save registers; that
# is its choice, not work the function needs.)
B1_OPS_PER_PAIR, B2_OPS_PER_PAIR = 25, 65
H, W = 1080, 1920
SCENE_BUDGETS = dict(
    tile_size=32, max_tile_span=4, isect_padding_multiplier=8,
    tile_capacity=512, tight_cull=False,
)
BACKGROUND = (0.1, 0.1, 0.1)
TRAIN_SEED, TRAIN_STEPS, TRAIN_LR = 0, 10, 1e-3
# Standard deviation of the noise added to each raw parameter before
# training (the scene's gaussians are ~0.015 world units across).
PERTURB = dict(means3d=2e-3, scales=0.05, quats=0.02, opacities_raw=0.2, features=0.02)
KEYS = ("means3d", "scales", "quats", "opacities", "features")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, runs: int, warmup: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs, each between two
    CUDA events and a synchronize, after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, exps: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations, the f32 ones over the f32 rate or the
    exponentials over the special-function units' rate, whichever is
    longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, exps / SFU_EXP_PER_S) * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def blend_agreement(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Apply the B1 rule; print the differing count and the max; return it."""
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    n_diff = int((diff > BLEND_ATOL).sum())
    max_err = float(diff.max())
    share = n_diff / diff.numel()
    phase(name, f"{n_diff} of {diff.numel()} values differ by more than "
          f"{BLEND_ATOL} ({share:.3e}); max abs diff {max_err:.3e}")
    if share > BLEND_MAX_SHARE or max_err > BLEND_MAX_ERR:
        raise AssertionError(
            f"{name}: disagrees with the plain version (share {share:.3e} > "
            f"{BLEND_MAX_SHARE} or max {max_err:.3e} > {BLEND_MAX_ERR})"
        )
    return max_err


def grad_agreement(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Apply the gradient rule to rows of ``got`` against ``want`` (the first
    axis indexes rows); print the share, the max; return the max abs diff."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    got2, want2 = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    diff = (got2 - want2).abs()
    rel = diff / (want2.abs().amax(dim=1, keepdim=True) + 1e-30)
    n_off = int((rel > GRAD_REL_ATOL).sum())
    share, max_rel = n_off / rel.numel(), float(rel.max())
    phase(name, f"{n_off} of {rel.numel()} values off by more than {GRAD_REL_ATOL} "
          f"of their row's scale ({share:.3e}); max {max_rel:.3e} of the scale, "
          f"max abs diff {float(diff.max()):.3e}")
    if share > GRAD_MAX_SHARE or max_rel > GRAD_MAX_REL:
        raise AssertionError(
            f"{name}: disagrees (share {share:.3e} > {GRAD_MAX_SHARE} or max "
            f"{max_rel:.3e} > {GRAD_MAX_REL} of the row scale)")
    return float(diff.max())


def main() -> int:
    # ---- 1. Device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from mojosplat_tpu_torch import Camera, RenderConfig, _kernels, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops import binning as binning_mod
    from mojosplat_tpu_torch.ops.expand_cuda import (
        segment_expand_offsets, segment_expand_offsets_plain)
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.raster_cuda import (
        gather_tile_data, raster_tiles, raster_tiles_bwd, raster_tiles_bwd_plain,
        raster_tiles_fwd, raster_tiles_plain)
    from mojosplat_tpu_torch.ops.segsum_cuda import segment_sum_cols, segment_sum_cols_plain
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.slice_cuda import (
        segment_slice_gather, segment_slice_gather_plain)
    from mojosplat_tpu_torch.train import activate, l2_image_loss, make_optimizer, train_step
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 2. Build
    t0 = time.perf_counter()
    _, log = _kernels.build()
    _kernels.library()
    phase("build", f"{time.perf_counter() - t0:.2f} s for "
          f"{', '.join(p.name for p in _kernels.sources())}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            phase("build", line.strip())

    # ---- 3. Golden
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    gp = params_from_numpy(
        {k[3:]: v for k, v in golden.items() if k.startswith("in_")}, dev)
    gcam = Camera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0,
                         fy=70.0, cx=32.0, cy=32.0, device=dev)
    gcfg = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl="cuda")

    def render_golden(p):
        return render_gaussians(*(p[k] for k in KEYS), gcam, sh_degree=2,
                                background_color=(0.15, 0.05, 0.25), config=gcfg,
                                return_depth=True)

    with torch.no_grad():
        img, depth = render_golden(gp)
    img, depth = img.cpu().numpy(), depth.cpu().numpy()
    np.testing.assert_allclose(img, golden["image"], rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    depth_atol = GOLDEN_ATOL * (float(np.abs(golden["aux_depth"]).max()) + 1.0)
    np.testing.assert_allclose(depth, golden["aux_depth"], rtol=GOLDEN_RTOL, atol=depth_atol)
    phase("golden", f"image max abs diff {np.abs(img - golden['image']).max():.3e}, "
          f"depth {np.abs(depth - golden['aux_depth']).max():.3e}: ok")

    # ---- 4. Kernels against their plain versions at the scene's shapes
    t0 = time.perf_counter()
    raw = load_compressed_scene(str(ROOT / TRAINED_SCENE))
    raw_dev = params_from_numpy(raw, dev)
    params = activate(raw_dev)
    n = params["means3d"].shape[0]
    sh_degree = int(round(params["features"].shape[1] ** 0.5)) - 1
    cam = scene_camera(H, W, device=dev)
    torch.cuda.synchronize()
    phase("scene", f"{n} gaussians, SH degree {sh_degree}, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg_torch = RenderConfig(raster_impl="torch", **SCENE_BUDGETS)
    cfg_cuda = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    ts, cap = cfg_torch.tile_size, cfg_torch.tile_capacity
    th, tw = binning_mod.num_tiles(H, W, ts)
    n_tiles, P = th * tw, ts * ts

    kernels = []
    with torch.no_grad():
        proj = project_gaussians(params["means3d"], params["scales"], params["quats"],
                                 params["opacities"], cam, cfg_torch)
        colors = sh_to_color(params["features"], params["means3d"], cam.position, sh_degree)
        pre = binning_mod.presort_gaussians(proj.means2d, proj.radii, proj.depths,
                                            th, tw, cfg_torch)
        capacity = binning_mod.isect_capacity(n, cfg_torch)
        bins = binning_mod.bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths,
                                                  H, W, cfg_torch)
        ranges = bins.tile_ranges.reshape(-1, 2)
        starts = ranges[:, 0].contiguous()
        counts = torch.clamp(ranges[:, 1] - ranges[:, 0], 0, cap).to(torch.int32)
        total = int(pre.total)

        # B4: (F, N) int32 read once, (F, capacity) int32 written once.
        got = segment_expand_offsets(pre.fields, capacity)
        want = segment_expand_offsets_plain(pre.fields, capacity)
        live = min(total, capacity)
        if not torch.equal(got[:, :live], want[:, :live]):
            raise AssertionError("B4: kernel and plain version differ on slots < total")
        repeats = torch.diff(pre.fields[0], append=pre.total.reshape(1))
        kernels.append(dict(
            name="B4 segment_expand_offsets", route="cuda",
            source="mojosplat_tpu_torch/csrc/expand.cu",
            replaces="mojosplat_tpu/ops/expand_pallas.py:143",
            max_abs_err=float((got[:, :live] - want[:, :live]).abs().max()) if live else 0.0,
            ms=cuda_ms(lambda: segment_expand_offsets(pre.fields, capacity), 20, 3),
            plain_ms=cuda_ms(lambda: segment_expand_offsets_plain(pre.fields, capacity), 20, 3),
            **bound(4 * (pre.fields.numel() + pre.fields.shape[0] * capacity), 0),
            library_ms=cuda_ms(lambda: torch.repeat_interleave(
                pre.fields, repeats, dim=1, output_size=total), 20, 3),
        ))
        phase("B4", f"{pre.fields.shape[1]} gaussians -> {capacity} slots "
              f"({total} demanded): exact on slots < total")

        # B5: starts, the distinct list entries the tiles' windows cover,
        # and the (n_tiles * cap,) table.
        got = segment_slice_gather(bins.gaussian_ids, starts, cap)
        want = segment_slice_gather_plain(bins.gaussian_ids, starts, cap)
        if not torch.equal(got, want):
            raise AssertionError("B5: kernel and plain version differ")
        M = bins.gaussian_ids.shape[0]
        edge = torch.zeros(M + 1, dtype=torch.int32, device=dev)
        one = torch.ones(n_tiles, dtype=torch.int32, device=dev)
        edge.index_add_(0, starts.clamp(0, M).long(), one)
        edge.index_add_(0, (starts + cap).clamp(0, M).long(), -one)
        covered = int((torch.cumsum(edge[:M], 0) > 0).sum())
        kernels.append(dict(
            name="B5 segment_slice_gather", route="cuda",
            source="mojosplat_tpu_torch/csrc/slice.cu",
            replaces="mojosplat_tpu/ops/slice_pallas.py:36",
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: segment_slice_gather(bins.gaussian_ids, starts, cap), 20, 3),
            plain_ms=cuda_ms(lambda: segment_slice_gather_plain(bins.gaussian_ids, starts, cap), 20, 3),
            **bound(4 * (n_tiles + covered + n_tiles * cap), 0),
            library_ms=None,
        ))
        phase("B5", f"{n_tiles} tiles x {cap} slots: exact")
        slot_gids = got

        # B1: the slots each tile blends, counts, and the output; the pairs
        # each pixel walks up to its stop, from the residual's stop index.
        pdata = gather_tile_data(proj.means2d, proj.conics, colors, params["opacities"],
                                 slot_gids, counts)
        rows = pdata.shape[0]
        out = raster_tiles(pdata, counts, ts, tw, cfg_cuda)
        ref = raster_tiles_plain(pdata, counts, ts, tw, cfg_cuda)
        err = blend_agreement("B1", out, ref)
        out_r, resid = raster_tiles_fwd(pdata, counts, ts, tw, cfg_cuda, residual=True)
        if not torch.equal(out_r, out):
            raise AssertionError("B1: the output changes when the residual is written")
        walked = torch.minimum(resid[1], counts[:, None])
        pairs = int(walked.sum())
        slots = int(counts.sum())
        kernels.append(dict(
            name="B1 raster_tiles (blend forward)", route="cuda",
            source="mojosplat_tpu_torch/csrc/raster_fwd.cu",
            replaces="mojosplat_tpu/ops/raster_pallas.py:491",
            max_abs_err=err,
            ms=cuda_ms(lambda: raster_tiles(pdata, counts, ts, tw, cfg_cuda), 20, 3),
            ms_with_residual=cuda_ms(
                lambda: raster_tiles_fwd(pdata, counts, ts, tw, cfg_cuda, True), 20, 3),
            plain_ms=cuda_ms(lambda: raster_tiles_plain(pdata, counts, ts, tw, cfg_cuda), 20, 3),
            **bound(4 * (rows * slots + n_tiles + out.numel()), B1_OPS_PER_PAIR * pairs, pairs),
            library_ms=None,
        ))
        phase("B1", f"pdata {tuple(pdata.shape)}, {slots} slots, {pairs} (pixel, slot) "
              f"pairs walked; bit-equal with the residual written")
        del ref, out_r

        # B2: pdata's blended slots, gout, the residual's walked chunks and
        # stop, counts, and d pdata written once.
        rng = np.random.default_rng(1)
        gout = torch.from_numpy(
            rng.standard_normal((n_tiles, rows - 5, P), dtype=np.float32)).to(dev)
        d_pdata = raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda)
        cfg_plain = RenderConfig(raster_impl="cuda", tile_batch=128, **SCENE_BUDGETS)
        d_want = raster_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg_plain)
        err = grad_agreement("B2", d_pdata, d_want)
        if not torch.equal(raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda),
                           d_pdata):
            raise AssertionError("B2: two runs differ")
        chunk_reads = int(((walked + 15) // 16).sum())
        kernels.append(dict(
            name="B2 raster_tiles_bwd (blend backward)", route="cuda",
            source="mojosplat_tpu_torch/csrc/raster_bwd.cu",
            replaces="mojosplat_tpu/ops/raster_pallas.py:540",
            max_abs_err=err,
            ms=cuda_ms(lambda: raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda),
                       20, 3),
            plain_ms=cuda_ms(lambda: raster_tiles_bwd_plain(
                pdata, counts, gout, ts, tw, cfg_plain), 3, 1),
            **bound(4 * (rows * slots + gout.numel() + chunk_reads + resid[1].numel()
                         + n_tiles + d_pdata.numel()), B2_OPS_PER_PAIR * pairs, pairs),
            library_ms=None,
        ))
        phase("B2", f"d pdata {tuple(d_pdata.shape)} from a seeded gout; two runs "
              f"bitwise equal")
        del d_want

        # B3: the gather adjoint's keys (the clamped slot ids, n past each
        # tile's count) sorted, with B2's first 6 + C rows as the payload;
        # reads the columns and keys once, writes (F, N) once, one add per
        # value.
        safe = slot_gids.clamp(0, n - 1)
        live = (torch.arange(cap, device=dev)[None, :] < counts[:, None]).reshape(-1)
        keys, perm = torch.sort(torch.where(live, safe, n), stable=True)
        longest = [int(torch.bincount(k).max()) for k in (safe, keys[keys < n])]
        cols = d_pdata[: 6 + colors.shape[1]].index_select(1, perm).contiguous()
        seg = segment_sum_cols(cols, keys, n)
        seg_want = segment_sum_cols_plain(cols, keys, n)
        diff = (seg - seg_want).abs()
        tol = 1e-5 * (seg_want.abs().amax(dim=1, keepdim=True) + seg_want.abs())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"B3: disagrees with index_add_ (max {float(diff.max()):.3e})")
        if not torch.equal(segment_sum_cols(cols, keys, n), seg):
            raise AssertionError("B3: two runs differ")
        keys64 = keys.long()
        sink = torch.zeros((cols.shape[0], n + 1), device=dev)  # + the dropped key
        routed = cols.shape[0] * int(live.sum())  # the values B3 reads and adds
        kernels.append(dict(
            name="B3 segment_sum_cols", route="cuda",
            source="mojosplat_tpu_torch/csrc/segsum.cu",
            replaces="mojosplat_tpu/ops/segsum_pallas.py:79",
            max_abs_err=float(diff.max()),
            ms=cuda_ms(lambda: segment_sum_cols(cols, keys, n), 20, 3),
            plain_ms=cuda_ms(lambda: segment_sum_cols_plain(cols, keys, n), 20, 3),
            **bound(4 * (routed + keys.numel() + cols.shape[0] * n), routed),
            library_ms=cuda_ms(lambda: sink.index_add_(1, keys64, cols), 20, 3),
        ))
        phase("B3", f"{cols.shape[0]} x {cols.shape[1]} sorted values -> {n} segments "
              f"({int(live.sum())} live slots; longest segment {longest[1]}, "
              f"{longest[0]} if the slots past the counts were routed too); "
              f"within rtol 1e-5 of index_add_, two runs bitwise equal")
        for k in kernels:
            lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
            phase("time", f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
                  f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library {lib}")
        del proj, colors, pre, bins, pdata, out, got, want, resid, gout, d_pdata
        del cols, seg, seg_want, sink, keys, keys64, perm, safe, live, slot_gids, edge, repeats

    # ---- 5. The main path, serving: render the trained scene on the "cuda" route
    counters = (segment_expand_offsets, segment_slice_gather, raster_tiles,
                raster_tiles_bwd, segment_sum_cols)

    def reset_counters():
        for fn in counters:
            fn.launches = 0
        raster_tiles_fwd.residuals = 0

    def render(p, config, camera=cam, background=BACKGROUND, **kw):
        return render_gaussians(
            *(p[k] for k in KEYS), camera, sh_degree=sh_degree, background_color=background,
            config=config, **kw)

    def drop_counters(aux):
        out = {k: int(v) for k, v in aux.binning._asdict().items()}
        out["tile_overflow"] = int(aux.raster.tile_overflow)
        return out

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        image, aux = render(params, cfg_cuda, return_aux=True)
        torch.cuda.synchronize()
        launches_render = [fn.launches for fn in counters]
        peak = torch.cuda.max_memory_allocated(dev)
        phase("render", f"launches during the render: B4 {launches_render[0]}, "
              f"B5 {launches_render[1]}, B1 {launches_render[2]}, B2 {launches_render[3]}, "
              f"B3 {launches_render[4]}; residuals written {raster_tiles_fwd.residuals}")
        if min(launches_render[:3]) < 1:
            raise AssertionError("a kernel of the path was not launched by the render")
        if max(launches_render[3:]) or raster_tiles_fwd.residuals:
            raise AssertionError("the no-grad render ran a backward kernel or wrote a residual")
        if image.shape != (H, W, 3) or not bool(torch.isfinite(image).all()):
            raise AssertionError(f"render: bad image {tuple(image.shape)} or non-finite")
        counts_cuda = drop_counters(aux)
        phase("render", "counters " + json.dumps(counts_cuda))

        image_t, aux_t = render(params, cfg_torch, return_aux=True)
        counts_torch = drop_counters(aux_t)
        if counts_torch != counts_cuda:
            raise AssertionError(f"route counters differ: {counts_torch} vs {counts_cuda}")
        blend_agreement("render vs torch route", image, image_t)
        del image_t, aux_t

        render_ms = cuda_ms(lambda: render(params, cfg_cuda), 10, 1)
        torch_ms = cuda_ms(lambda: render(params, cfg_torch), 10, 1)
        phase("render", f"median of 10: cuda route {render_ms:.3f} ms "
              f"({H * W / (render_ms / 1e3):.1f} pixels/s), torch route {torch_ms:.3f} ms; "
              f"peak memory of one cuda-route render {peak} bytes")
        # train_step renders on the default (black) background.
        target = render(params, cfg_cuda, background=None)

    # ---- 6. Golden gradients on the "cuda" route
    gleaves = {k: v.clone().requires_grad_(True) for k, v in gp.items()}
    img, depth = render_golden(gleaves)
    (torch.mean(img**2) + 1e-3 * torch.mean(depth**2)).backward()
    worst = []
    for k in KEYS:
        g, want = gleaves[k].grad.cpu().numpy(), golden[f"grad_{k}"]
        np.testing.assert_allclose(g, want, rtol=GOLDEN_RTOL,
                                   atol=GOLDEN_ATOL * float(np.abs(want).max()),
                                   err_msg=f"golden gradient {k}")
        worst.append(f"{k} {np.abs(g - want).max():.3e}")
    phase("golden-grad", "max abs diff " + ", ".join(worst) + ": ok")

    # ---- 7. The main path, training: 10 Adam steps on the trained scene
    rng = np.random.default_rng(TRAIN_SEED)
    leaves = {
        k: torch.from_numpy(v + rng.standard_normal(v.shape, dtype=np.float32) * PERTURB[k])
        .to(dev).requires_grad_(True)
        for k, v in raw.items()
    }
    opt = make_optimizer(leaves, lr=TRAIN_LR)
    phase("train", f"Adam lr {TRAIN_LR}; raw parameters perturbed by N(0, s^2) noise "
          f"(numpy seed {TRAIN_SEED}), s = {json.dumps(PERTURB)}; target: the cuda-route "
          f"render of the unperturbed scene")
    with torch.no_grad():
        _, aux = render(activate(leaves), cfg_cuda, background=None, return_aux=True)
    phase("train", "counters at the start " + json.dumps(drop_counters(aux)))

    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        if i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counters()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = train_step(leaves, opt, [cam], target[None], sh_degree=sh_degree,
                          config=cfg_cuda)
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            launches_train = [fn.launches for fn in counters]
            peak_train = torch.cuda.max_memory_allocated(dev)
            residuals_train = raster_tiles_fwd.residuals
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    with torch.no_grad():
        final = float(l2_image_loss(render(activate(leaves), cfg_cuda, background=None),
                                    target))
    phase("train", "loss per step " + ", ".join(f"{x:.6e}" for x in losses)
          + f"; after step {TRAIN_STEPS}: {final:.6e}")
    phase("train", f"launches during one step: B4 {launches_train[0]}, B5 {launches_train[1]}, "
          f"B1 {launches_train[2]}, B2 {launches_train[3]}, B3 {launches_train[4]}; "
          f"residuals written {residuals_train}")
    if not all(np.isfinite(losses)) or not np.isfinite(final) or not final < losses[0]:
        raise AssertionError("train: the loss is not finite or did not fall")
    if min(launches_train) < 1:
        raise AssertionError("train: a kernel of the path was not launched by the step")
    med = statistics.median(step_ms)
    phase("train", f"step time median of {TRAIN_STEPS} {med:.3f} ms (steps "
          + ", ".join(f"{x:.3f}" for x in step_ms) + f"), {1e3 / med:.3f} steps/s; "
          f"peak memory of one step {peak_train} bytes")

    def grads_of(p, config, camera, tgt):
        for t in p.values():
            t.grad = None
        l2_image_loss(render(activate(p), config, camera, background=None), tgt).backward()
        return {k: t.grad.clone() for k, t in p.items()}

    g1 = grads_of(leaves, cfg_cuda, cam, target)
    g2 = grads_of(leaves, cfg_cuda, cam, target)
    for k in g1:
        if not torch.equal(g1[k], g2[k]):
            raise AssertionError(f"train: two backward passes differ in d {k}")
    phase("train", "two backward passes on identical inputs: bitwise equal gradients")
    del g1, g2, opt

    # Both routes at a quarter of the resolution and every 4th gaussian: the
    # plain route's autograd keeps every chunk's intermediates.
    small = {k: v.detach()[::4].contiguous() for k, v in leaves.items()}
    cam_s = scene_camera(H // 4, W // 4, device=dev)
    with torch.no_grad():
        target_s = render(activate({k: v[::4] for k, v in raw_dev.items()}), cfg_cuda, cam_s,
                          background=None)
    routes = {}
    for name, config in (("cuda", cfg_cuda), ("torch", cfg_torch)):
        p = {k: v.clone().requires_grad_(True) for k, v in small.items()}
        routes[name] = grads_of(p, config, cam_s, target_s)
    for k in routes["cuda"]:
        grad_agreement(f"train d {k} cuda vs torch route ({small['means3d'].shape[0]} "
                       f"gaussians, {H // 4}x{W // 4})",
                       routes["cuda"][k][None], routes["torch"][k][None])
    del routes, small, leaves

    for k in kernels:
        k["launches"] = launches_train[
            ["B4", "B5", "B1", "B2", "B3"].index(k["name"][:2])]
        if k["name"][:2] in ("B4", "B5", "B1"):
            k["launches_render"] = launches_render[["B4", "B5", "B1"].index(k["name"][:2])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
