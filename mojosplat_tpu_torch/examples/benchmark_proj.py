"""Projection latency across gaussian counts, for the EWA and UT modes.

Port of ``examples/benchmark_proj.py``: for each count and projection
mode (``ewa``, the fused EWA linearisation; ``ut``, the unscented
transform through the exact camera map), three samples of
``utils.metrics.amortized_ms`` give the mean, spread, least and most time
of one ``project_gaussians`` call; then the results table, the throughput
scaling from the smallest count to the largest, the speed-up of the
fastest mode over the slowest at each count, and an optional log-log plot
(when matplotlib imports).

    python -m mojosplat_tpu_torch.examples.benchmark_proj --impls ewa ut \\
        --gaussians 1000 10000 100000 1000000

runs on the card (``--device cuda``, the default); ``--device cpu`` on the
CPU. The projection is plain PyTorch: no CUDA kernel runs here. The
gaussians are drawn from a ``torch.Generator`` seeded on the CPU with the
reference's distributions and then moved to the device, so the CPU and the
card project the same numbers; they differ from the reference's
``jax.random`` draws for the same seed. This is a tool for users: it writes
no benchmark file, and nothing reads its output as a metric.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import torch

from mojosplat_tpu_torch import Camera, RenderConfig, look_at
from mojosplat_tpu_torch.examples.train_colmap import resolve_device
from mojosplat_tpu_torch.ops.projection import project_gaussians
from mojosplat_tpu_torch.utils.metrics import amortized_ms


@dataclass
class BenchmarkResult:
    name: str
    n_gaussians: int
    mean_ms: float
    std_ms: float
    min_ms: float
    max_ms: float


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impls", nargs="+", default=["ewa", "ut"], choices=["ewa", "ut"],
                    help="projection modes to compare")
    ap.add_argument("--gaussians", type=int, nargs="+",
                    default=[1_000, 10_000, 100_000, 1_000_000])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3,
                    help="accepted for the reference's CLI; amortized_ms warms up itself")
    ap.add_argument("--plot", default=None, help="output PNG path for plot")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    return ap


def create_camera(height: int, width: int, *, device) -> Camera:
    """Eye (0, 1.5, 5) looking at the origin, fx = fy = 80, centred."""
    R, T = look_at([0.0, 1.5, 5.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device=device)
    return Camera.create(R=R, T=T, H=height, W=width, fx=80.0, fy=80.0, cx=width / 2,
                         cy=height / 2, device=device)


def generate_gaussian_data(n: int, seed: int = 42, *, device) -> tuple:
    """(means3d, log-scales, unit quats, opacities): N(0, 1) * 2 means,
    -3 + 0.1 N(0, 1) log-scales, normalised N(0, 1) quaternions and
    sigmoid(N(0, 1)) opacities, drawn on the CPU from a generator seeded
    with ``seed`` and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    means3d = randn(n, 3) * 2.0
    log_scales = -3.0 + randn(n, 3) * 0.1
    quats = randn(n, 4)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opacities = torch.sigmoid(randn(n))
    return tuple(t.to(device) for t in (means3d, log_scales, quats, opacities))


def benchmark_fn(name: str, fn, data: tuple, warmup: int, iters: int, n: int) -> BenchmarkResult:
    del warmup  # amortized_ms makes its own untimed call first
    reps = 3
    samples = [amortized_ms(fn, data, iters) for _ in range(reps)]
    mean = sum(samples) / reps
    std = (sum((t - mean) ** 2 for t in samples) / reps) ** 0.5
    return BenchmarkResult(name, n, mean, std, min(samples), max(samples))


def print_results_table(results) -> None:
    print(f"\n{'impl':<8} {'N':>10} {'mean ms':>10} {'std':>8} "
          f"{'min':>8} {'max':>8} {'gauss/s':>12}")
    print("-" * 70)
    for r in results:
        print(
            f"{r.name:<8} {r.n_gaussians:>10} {r.mean_ms:>10.3f} "
            f"{r.std_ms:>8.3f} {r.min_ms:>8.3f} {r.max_ms:>8.3f} "
            f"{r.n_gaussians / (max(r.mean_ms, 1e-3) / 1e3):>12.3e}"
        )


def plot_results(results, path: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    names = sorted({r.name for r in results})
    plt.figure(figsize=(8, 6))
    for name in names:
        rs = sorted([r for r in results if r.name == name], key=lambda r: r.n_gaussians)
        plt.loglog([r.n_gaussians for r in rs], [r.mean_ms for r in rs], marker="o",
                   label=name)
    plt.xlabel("gaussians")
    plt.ylabel("mean latency (ms)")
    plt.title("Projection latency")
    plt.grid(True, which="both", alpha=0.3)
    plt.legend()
    plt.savefig(path, dpi=120)
    plt.close()
    print(f"Plot saved to {path}")


def speedup_analysis(results) -> None:
    """The fastest against the slowest mode at each count."""
    by_n = {}
    for r in results:
        by_n.setdefault(r.n_gaussians, []).append(r)
    print("\nSpeedup analysis (per N, fastest vs slowest impl):")
    for n in sorted(by_n):
        rs = sorted(by_n[n], key=lambda r: r.mean_ms)
        if len(rs) < 2:
            continue
        fast, slow = rs[0], rs[-1]
        print(
            f"  N={n:>9}: {fast.name} {fast.mean_ms:.3f} ms vs "
            f"{slow.name} {slow.mean_ms:.3f} ms -> "
            f"{slow.mean_ms / max(fast.mean_ms, 1e-6):.2f}x"
        )


def main(argv=None) -> dict:
    """Run the sweep; returns the results (one per count and mode, in the
    table's order) and the throughput scaling of the first mode (None with
    one count)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device, "torch")
    camera = create_camera(args.height, args.width, device=dev)

    results = []
    for n in args.gaussians:
        data = generate_gaussian_data(n, device=dev) + (camera,)
        for impl in args.impls:
            cfg = RenderConfig(projection_mode=impl)

            def proj(m, s, q, o, cam, cfg=cfg):
                with torch.no_grad():
                    return project_gaussians(m, s, q, o, cam, cfg)

            results.append(benchmark_fn(impl, proj, data, args.warmup, args.iterations, n))
    print_results_table(results)

    scale = None
    per_impl = [r for r in results if r.name == args.impls[0]]
    if len(per_impl) >= 2:
        r0, r1 = per_impl[0], per_impl[-1]
        scale = (r1.n_gaussians / r0.n_gaussians) / (
            max(r1.mean_ms, 1e-3) / max(r0.mean_ms, 1e-3))
        print(f"\nThroughput scaling {r0.n_gaussians} -> {r1.n_gaussians}: "
              f"{scale:.2f}x work per unit time (1.0 = linear cost)")
    speedup_analysis(results)
    if args.plot:
        plot_results(results, args.plot)
    return dict(results=results, throughput_scaling=scale)


if __name__ == "__main__":
    main()
