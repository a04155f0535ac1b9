"""Per-stage latency of the render: projection, binning, rasterization,
the whole forward and the forward + backward.

Port of ``examples/benchmark.py``. For each gaussian count and route, the
stage inputs are computed once, then each stage is timed with
``utils.metrics.amortized_ms``: ``projection``, ``binning``,
``rasterization`` (from the binning, on a black background),
``e2e_forward`` (``render_gaussians`` on a [0.1, 0.1, 0.1] background) and
``e2e_fwd_bwd`` (``torch.autograd.grad`` of the mean squared image with
respect to the means). With more than one route or count, a table of the
forward and forward + backward times follows.

    python -m mojosplat_tpu_torch.examples.benchmark --gaussians 100000 --height 608 --width 800
    python -m mojosplat_tpu_torch.examples.benchmark --impls torch cuda --gaussians 10000 100000

runs on the card (``--device cuda``); ``--impls`` takes ``cuda`` (the
hand-written kernels, the default: B4 in the binning, B5 and B1 in the
rasterization, B2 and B3 in the backward) and ``torch`` (the plain
PyTorch route), the counterparts of the reference's ``pallas`` and
``xla``. ``--device cpu --impls torch`` runs on the CPU. The data are
``benchmark_proj``'s, with uniform colours from a CPU generator seeded 1;
they differ from the reference's ``jax.random`` draws. This is a tool for
users: it writes no benchmark file, and nothing reads its output as a
metric.
"""

from __future__ import annotations

import argparse

import torch

from mojosplat_tpu_torch import RenderConfig, render_gaussians
from mojosplat_tpu_torch.examples.benchmark_proj import create_camera, generate_gaussian_data
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
from mojosplat_tpu_torch.ops.projection import project_gaussians
from mojosplat_tpu_torch.ops.rasterization import rasterize_gaussians
from mojosplat_tpu_torch.utils.metrics import amortized_ms

BACKGROUND = (0.1, 0.1, 0.1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaussians", type=int, nargs="+", default=[100_000],
                    help="gaussian counts to sweep")
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2,
                    help="accepted for the reference's CLI; amortized_ms warms up itself")
    ap.add_argument("--tile-batch", type=int, default=512)
    ap.add_argument("--impls", nargs="+", default=["cuda"], choices=["torch", "cuda"],
                    help="routes to compare side by side: 'cuda', the hand-written "
                    "kernels (needs --device cuda); 'torch', the plain PyTorch route")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    return ap


def run_pipeline(args, camera, impl: str, n: int, time_stage=None) -> dict:
    """Time each stage of ``impl`` at ``n`` gaussians and print its table.
    Returns the stage times (ms) and ``num_isects``. ``time_stage(impl,
    name, fn, fn_args, iters)`` times one stage (default: ``amortized_ms(fn,
    fn_args, iters)``)."""
    if time_stage is None:
        def time_stage(impl, name, fn, fn_args, iters):
            return amortized_ms(fn, fn_args, iters)

    H, W = camera.H, camera.W
    cfg = RenderConfig(tile_batch=args.tile_batch, raster_impl=impl)
    dev = camera.R.device
    m, s, q, o = generate_gaussian_data(n, device=dev)
    colors = torch.rand((n, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    black = torch.zeros(3, device=dev)

    def project(m, s, q, o, cam):
        return project_gaussians(m, s, q, o, cam, cfg)

    def binning(m2, r, d):
        return bin_gaussians_to_tiles(m2, r, d, H, W, cfg)

    def rasterize(m2, cn, c, o, b):
        return rasterize_gaussians(m2, cn, c, o, black, b, H, W, cfg)[0]

    def fwd(m, s, q, o, c, cam):
        return render_gaussians(m, s, q, o, c, cam, background_color=BACKGROUND, config=cfg)

    def fwd_bwd(m, s, q, o, c, cam):
        mm = m.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(torch.mean(fwd(mm, s, q, o, c, cam) ** 2), mm)[0]

    results = {}
    with torch.no_grad():
        proj = project(m, s, q, o, camera)
        bins = binning(proj.means2d, proj.radii, proj.depths)
        for name, fn, fn_args in (
                ("projection", project, (m, s, q, o, camera)),
                ("binning", binning, (proj.means2d, proj.radii, proj.depths)),
                ("rasterization", rasterize, (proj.means2d, proj.conics, colors, o, bins)),
                ("e2e_forward", fwd, (m, s, q, o, colors, camera)),
                ("e2e_fwd_bwd", fwd_bwd, (m, s, q, o, colors, camera))):
            results[name] = time_stage(impl, name, fn, fn_args, args.iterations)

    num_isects = int(bins.aux.num_isects)
    npix = args.height * args.width
    print(f"\nN={n}  {args.width}x{args.height}  impl={impl}  isects={num_isects}")
    print(f"{'stage':<16} {'ms/iter':>10} {'Mpix/s':>10}")
    print("-" * 40)
    for name, ms in results.items():
        # amortized_ms floors at 0.0 for a stage below the clock's
        # resolution (tiny CPU shapes); keep the table printable.
        print(f"{name:<16} {ms:>10.3f} {npix / max(ms, 1e-3) / 1e3:>10.2f}")
    return dict(results, num_isects=num_isects)


def main(argv=None, time_stage=None) -> dict:
    """Run the sweep; returns {(n, impl): run_pipeline's dict}.
    ``time_stage`` is passed to ``run_pipeline``."""
    args = build_parser().parse_args(argv)
    dev = None
    for impl in args.impls:
        dev = resolve_device(args.device, impl)
    camera = create_camera(args.height, args.width, device=dev)
    table = {}
    for n in args.gaussians:
        for impl in args.impls:
            table[(n, impl)] = run_pipeline(args, camera, impl, n, time_stage)

    if len(args.impls) > 1 or len(args.gaussians) > 1:
        print(f"\n{'N':>10} {'impl':<8} {'fwd ms':>10} {'fwd+bwd ms':>12} "
              f"{'Mpix/s (fwdbwd)':>16}")
        print("-" * 62)
        npix = args.height * args.width
        for n in args.gaussians:
            for impl in args.impls:
                r = table[(n, impl)]
                fb = r["e2e_fwd_bwd"]
                print(f"{n:>10} {impl:<8} {r['e2e_forward']:>10.3f} "
                      f"{fb:>12.3f} {npix / max(fb, 1e-3) / 1e3:>16.2f}")
            if len(args.impls) > 1:
                ms = {i: table[(n, i)]["e2e_fwd_bwd"] for i in args.impls}
                fast = min(ms, key=ms.get)
                slow = max(ms, key=ms.get)
                if fast != slow:
                    print(f"{'':>10} -> {fast} is "
                          f"{ms[slow] / max(ms[fast], 1e-6):.2f}x faster "
                          f"than {slow}")
    return table


if __name__ == "__main__":
    main()
