#!/usr/bin/env python3
"""Time the segment sum B3, the slot slice B5, the slot gather's adjoint
around B3 and the host's launch path, at the trained scene's shapes on one
NVIDIA GPU.

Run from anywhere, naming the checkout whose package and kernels to use
(default: this script's own):

    python3 scripts/port_segsum_time.py [ROOT]

The inputs are chip_smoke.py's: the trained 1M-gaussian scene at 1920x1080
with preset 6's budgets. 3DGS (phase 4): B5 cuts the 2040 x 512 slot table
from the "torch" route's binning, B1 and B2 (a seeded cotangent) give the
slots' gradient rows, and the adjoint routes the first 9 of them by the
slot ids (dropped past each tile's count). 2DGS (phase 9): the scene read as
disks, B7 and B8 with the maps, 18 rows routed. For each family it prints,
as one JSON line:

  - B3 on the sorted payload (the parent design's input), and on the
    unsorted rows with ``perm`` where the tree's B3 takes it: the time of one
    call (median of 50 CUDA-event runs after 5 warm-ups, chip_smoke.cuda_ms),
    per call over 50 calls queued back to back (cuda_ms_queued: where the
    host's wrapper takes longer than the kernel, that is the host's time)
    and the kernel's own device time per launch (torch.profiler over 50
    calls; null where three profiler runs recorded no launch of it);
    whether it is bit-equal to its plain version run on CPU copies of the
    inputs;
  - where the tree's B3 wrapper runs torch.arange and torch.searchsorted,
    each of them and the kernel alone;
  - the gather adjoint (``raster_cuda._GatherRows.backward`` on these rows)
    and its pieces: the stable sort, the payload's index_select, the zeroed
    output with the copy of the summed rows, and the zeroed pad rows alone;
  - index_add_ on the same sorted payload (the library yardstick);
  - the live rows per window of 256 segments (mean, 99th percentile, max,
    empty windows): the work each of B3's blocks finds;

then B5 single, queued and its device time, exact against its plain
version; and the host's
microseconds per call over 1000 calls (host clock, one synchronize at the
end, tiny shapes so the device never holds the host back) of
``_kernels.launch`` on B5's entry point, of the B5 and B3 wrappers, and of
the pieces of a launch: the device switch, the current stream, the entry
point's lookup, ``require`` and ``torch.empty``. To compare two trees, run
it on each in one call.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

RUNS, WARMUP, HOST_CALLS = 50, 5, 1000


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn()`` over ``calls`` calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def device_ms(fn, kernel: str, runs: int = RUNS) -> float:
    """Device milliseconds per launch of the kernel whose name holds
    ``kernel``, from torch.profiler over ``runs`` calls of ``fn()`` after a
    warm-up: the kernel's own time, without the host's launch path."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # the tracer now and then records no device event
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and kernel in evt.key:
                us += float(getattr(evt, "self_device_time_total", 0.0)
                            or getattr(evt, "self_cuda_time_total", 0.0))
                count += evt.count
        if count == runs:
            return us / 1e3 / count
    return None  # not measured


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parent.parent).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("port_segsum_time: torch.cuda.is_available() is False")
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mojosplat_tpu_torch import RenderConfig, _kernels
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops import binning
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.raster_cuda import (
        _GatherRows, gather_tile_data, raster_tiles_bwd, raster_tiles_fwd)
    from mojosplat_tpu_torch.ops.segsum_cuda import segment_sum_cols, segment_sum_cols_plain
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.slice_cuda import (
        segment_slice_gather, segment_slice_gather_plain)
    from mojosplat_tpu_torch.ops.surfel_cuda import (
        raster_surfel_tiles_bwd, raster_surfel_tiles_fwd)
    from mojosplat_tpu_torch.surfel import bin_surfels, pack_surfel_tiles
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    takes_perm = "perm" in inspect.signature(segment_sum_cols).parameters
    res = dict(tree=str(root), device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               b3_takes_perm=takes_perm)

    def ms(fn):
        return dict(ms=cs.cuda_ms(fn, RUNS, WARMUP), ms_queued=cs.cuda_ms_queued(fn, RUNS, WARMUP))

    raw = load_compressed_scene(str(root / TRAINED_SCENE))
    sh_degree = int(round(raw["features"].shape[1] ** 0.5)) - 1
    cam = scene_camera(cs.H, cs.W, device=dev)
    cfg_torch = RenderConfig(raster_impl="torch", **cs.SCENE_BUDGETS)
    cfg_cuda = RenderConfig(raster_impl="cuda", **cs.SCENE_BUDGETS)
    ts, cap = cfg_cuda.tile_size, cfg_cuda.tile_capacity
    th, tw = binning.num_tiles(cs.H, cs.W, ts)
    n_tiles, P = th * tw, ts * ts

    def adjoint_inputs(ids, starts, counts, n):
        slot_gids = segment_slice_gather(ids, starts, cap)
        safe = slot_gids.clamp(0, n - 1)
        live = (torch.arange(cap, device=dev)[None, :] < counts[:, None]).reshape(-1)
        return slot_gids, torch.where(live, safe, n).to(torch.int32)

    families = {}
    with torch.no_grad():
        params = activate(params_from_numpy(raw, dev))
        n = params["means3d"].shape[0]
        proj = project_gaussians(params["means3d"], params["scales"], params["quats"],
                                 params["opacities"], cam, cfg_torch)
        colors = sh_to_color(params["features"], params["means3d"], cam.position, sh_degree)
        bins = binning.bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, cs.H, cs.W,
                                              cfg_torch, conics=proj.conics,
                                              opacities=params["opacities"])
        ranges = bins.tile_ranges.reshape(-1, 2)
        starts = ranges[:, 0].contiguous()
        counts = torch.clamp(ranges[:, 1] - ranges[:, 0], 0, cap).to(torch.int32)
        slot_gids, keys = adjoint_inputs(bins.gaussian_ids, starts, counts, n)
        pdata = gather_tile_data(proj.means2d, proj.conics, colors, params["opacities"],
                                 slot_gids, counts)
        _, resid = raster_tiles_fwd(pdata, counts, ts, tw, cfg_cuda, residual=True)
        gout = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (n_tiles, pdata.shape[0] - 5, P), dtype=np.float32)).to(dev)
        g = raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda)
        families["3dgs"] = (g, keys, 6 + colors.shape[1], n)
        b5_inputs = (bins.gaussian_ids, starts)
        del proj, pdata, resid, gout, params

        disks = dict(raw, scales=np.ascontiguousarray(raw["scales"][:, :2]))
        params = activate(params_from_numpy(disks, dev))
        geometry = [params[k] for k in ("means3d", "scales", "quats", "opacities")]
        bins2 = bin_surfels(*geometry, cam, cfg_cuda)
        colors2 = sh_to_color(params["features"], params["means3d"], cam.position, sh_degree)
        pdata2, counts2 = pack_surfel_tiles(*geometry, colors2, cam, bins2, cfg_cuda, True)
        ranges2 = bins2.tile_ranges.reshape(-1, 2)
        _, keys2 = adjoint_inputs(bins2.gaussian_ids, ranges2[:, 0].contiguous(), counts2, n)
        _, resid2 = raster_surfel_tiles_fwd(pdata2, counts2, ts, tw, cfg_cuda, True, True)
        gout2 = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (n_tiles, 9, P), dtype=np.float32)).to(dev)
        g2 = raster_surfel_tiles_bwd(pdata2, counts2, gout2, resid2, ts, tw, cfg_cuda, True)
        families["2dgs"] = (g2, keys2, pdata2.shape[0], n)
        del params, bins2, pdata2, resid2, gout2

        for family, (g, keys_raw, F, n) in families.items():
            keys_s, perm = torch.sort(keys_raw, stable=True)
            cols = g[:F].index_select(1, perm).contiguous()
            out = dict(F=F, M=keys_raw.shape[0], live=int((keys_raw < n).sum()), segments=n)
            per_window = torch.bincount(keys_s[keys_s < n].long() // 256,
                                        minlength=-(-n // 256)).float()
            out["rows_per_window"] = dict(
                mean=float(per_window.mean()), max=int(per_window.max()),
                p99=float(torch.quantile(per_window, 0.99)),
                empty=int((per_window == 0).sum()), windows=per_window.numel())
            got = segment_sum_cols(cols, keys_s, n)
            want = segment_sum_cols_plain(cols.cpu(), keys_s.cpu(), n)
            out["b3_equal_cpu_plain"] = bool(torch.equal(got.cpu(), want))
            out["b3_two_runs_equal"] = bool(torch.equal(segment_sum_cols(cols, keys_s, n), got))
            out["b3"] = ms(lambda: segment_sum_cols(cols, keys_s, n))
            out["b3"]["device_ms"] = device_ms(
                lambda: segment_sum_cols(cols, keys_s, n), "segsum_kernel")
            if takes_perm:
                gf = g[:F]
                got_p = segment_sum_cols(gf, keys_s, n, perm=perm)
                out["b3_perm_equal_cpu_plain"] = bool(torch.equal(got_p.cpu(), want))
                out["b3_perm"] = ms(lambda: segment_sum_cols(gf, keys_s, n, perm=perm))
                out["b3_perm"]["device_ms"] = device_ms(
                    lambda: segment_sum_cols(gf, keys_s, n, perm=perm), "segsum_kernel")
            else:
                bounds = torch.searchsorted(
                    keys_s, torch.arange(n + 1, dtype=torch.int32, device=dev))
                seg = torch.empty((F, n), dtype=torch.float32, device=dev)
                out["b3_arange"] = ms(lambda: torch.arange(n + 1, dtype=torch.int32, device=dev))
                ar = torch.arange(n + 1, dtype=torch.int32, device=dev)
                out["b3_searchsorted"] = ms(lambda: torch.searchsorted(keys_s, ar))
                out["b3_kernel"] = ms(lambda: _kernels.launch(
                    "segsum_launch", dev, cols.data_ptr(), F, cols.shape[1],
                    bounds.data_ptr(), n, seg.data_ptr()))
            out["sort"] = ms(lambda: torch.sort(keys_raw, stable=True))
            out["index_select"] = ms(lambda: g[:F].index_select(1, perm).contiguous())

            def zeros_copy():
                d = torch.zeros((g.shape[0], n), dtype=g.dtype, device=dev)
                d[:F] = got

            def pad_zero():
                torch.empty((g.shape[0], n), dtype=g.dtype, device=dev)[F:].zero_()

            out["zeros_copy"] = ms(zeros_copy)
            out["pad_zero"] = ms(pad_zero)
            ctx = SimpleNamespace(saved_tensors=(keys_raw,), n=n, nfields=F,
                                  needs_input_grad=(True, False, False, False, False))
            d_packed = _GatherRows.backward(ctx, g)[0]
            out["adjoint_rows_equal_b3"] = bool(torch.equal(d_packed[:F], got))
            out["adjoint"] = ms(lambda: _GatherRows.backward(ctx, g))
            keys64 = keys_s.long()
            sink = torch.zeros((F, n + 1), device=dev)
            out["index_add"] = ms(lambda: sink.index_add_(1, keys64, cols))
            res[family] = out
            del cols, got, want, sink, keys64

        ids, starts = b5_inputs
        got = segment_slice_gather(ids, starts, cap)
        res["b5"] = dict(n_tiles=n_tiles, cap=cap, equal_plain=bool(
            torch.equal(got, segment_slice_gather_plain(ids, starts, cap))),
            device_ms=device_ms(lambda: segment_slice_gather(ids, starts, cap),
                                "slice_gather_kernel"),
            **ms(lambda: segment_slice_gather(ids, starts, cap)))

        # The host's launch path, at tiny shapes.
        src = torch.arange(64, dtype=torch.int32, device=dev)
        st = torch.zeros(1, dtype=torch.int32, device=dev)
        small = torch.empty(4, dtype=torch.int32, device=dev)
        c9 = torch.ones((9, 64), dtype=torch.float32, device=dev)
        k9 = torch.arange(64, dtype=torch.int32, device=dev)
        lib = _kernels.library()

        def switch():
            with torch.cuda.device(dev):
                pass

        res["host_us"] = dict(
            launch=host_us(lambda: _kernels.launch(
                "slice_gather_launch", dev, src.data_ptr(), 64, st.data_ptr(), 1, 4,
                small.data_ptr())),
            b5_wrapper=host_us(lambda: segment_slice_gather(src, st, 4)),
            b3_wrapper=host_us(lambda: segment_sum_cols(c9, k9, 64)),
            device_switch=host_us(switch),
            current_stream=host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
            entry_lookup=host_us(lambda: getattr(lib, "slice_gather_launch")),
            require=host_us(lambda: _kernels.require(src, "src", torch.int32, 1)),
            empty=host_us(lambda: torch.empty((4,), dtype=torch.int32, device=dev)),
        )
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
