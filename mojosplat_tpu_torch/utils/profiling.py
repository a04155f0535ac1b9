"""Profiler tracing and roofline accounting.

Port of ``mojosplat_tpu.utils.profiling``:

  - ``trace(logdir)``: a ``torch.profiler`` capture of the host and, on the
    card, the device; it writes a Chrome trace (``trace.json``, opens in
    Perfetto or ``chrome://tracing``) under ``logdir``.
  - ``annotate(name)``: a named region (``record_function``), so pipeline
    stages are attributable inside a capture.
  - ``roofline_report(...)``: achieved pixels/s beside the lower-bound
    memory and f32 demands of a 3DGS render step over a device's peaks,
    with the reference's demand model.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

import torch

# Peak numbers per device, used only as roofline denominators. "h100": the
# H100 SXM5 80GB data sheet's HBM3 rate, f32 rate outside the tensor cores
# (the blend's arithmetic; the "vpu" key keeps the reference's name for
# the vector rate) and dense bf16 tensor-core rate.
CHIP_PEAKS = {
    "h100": {"bf16_tflops": 989.0, "vpu_tflops": 67.0, "hbm_gbps": 3350.0},
    # harness testing only:
    "cpu": {"bf16_tflops": 1.0, "vpu_tflops": 0.1, "hbm_gbps": 50.0},
}


@contextmanager
def trace(logdir: str, device: torch.device | str = "cuda"):
    """Capture a trace under ``logdir`` (``logdir/trace.json``).

    Records CUDA activity besides the host's when ``device`` is a CUDA
    device (the default), the host only for ``"cpu"``. The work must
    finish inside the context::

        with trace("build/trace"):
            loss = train_step(...)
            torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextmanager
def annotate(name: str):
    """Named region inside a trace capture (a span on the host timeline,
    enclosing the kernels it launches)."""
    with torch.profiler.record_function(name):
        yield


@dataclass(frozen=True)
class RooflineReport:
    """Achieved throughput vs lower-bound resource demands of one train step.

    All "demand" fields are *lower bounds* computed from workload shape, not
    measured counters: bytes assume each operand is touched once from HBM;
    FLOPs count only the unavoidable per-(pixel, intersection) blending math
    and per-gaussian projection math. Ratios > 1.0 are impossible; a ratio of
    0.5 means the step runs at half the speed light allows for that resource.
    """

    pixels_per_s: float
    step_ms: float
    hbm_bytes_demand: float
    flops_demand: float
    hbm_bound_ms: float  # demand / device HBM peak
    flop_bound_ms: float  # demand / device f32 peak
    light_speed_ms: float  # max(hbm_bound, flop_bound)
    fraction_of_light: float  # light_speed_ms / step_ms

    def as_dict(self) -> dict:
        return {
            "pixels_per_s": self.pixels_per_s,
            "step_ms": self.step_ms,
            "hbm_bound_ms": self.hbm_bound_ms,
            "flop_bound_ms": self.flop_bound_ms,
            "light_speed_ms": self.light_speed_ms,
            "fraction_of_light": self.fraction_of_light,
        }


def roofline_report(
    step_ms: float,
    n_pixels: int,
    n_isects: int,
    n_gaussians: int,
    sh_bases: int = 16,
    backward: bool = True,
    chip: str = "h100",
    tile_size: int = 16,
) -> RooflineReport:
    """Roofline accounting for one fwd(+bwd) render step.

    Demand model (lower bounds, the reference's):
      - HBM: gaussian parameters + SH coefficients read once per pass;
        per-intersection slot records written+read once by binning/gather
        (12 f32 fields: mean, conic, color, opacity, ids, residuals);
        image + grads once.
      - FLOPs (f32): ~24 per (pixel, intersection) pair per pass for the
        EWA blend (sigma 5 FMA, exp, alpha/transmittance update, 3-channel
        accumulate), every pair of a tile counted; plus ~300 per gaussian
        for projection and 2*sh_bases*3 for SH.
    """
    peaks = CHIP_PEAKS[chip]
    passes = 2.6 if backward else 1.0  # bwd re-walks tiles + routes grads

    param_bytes = n_gaussians * (11 + 3 * sh_bases) * 4.0
    slot_bytes = n_isects * 12 * 4.0 * (3.0 if backward else 2.0)
    image_bytes = n_pixels * 4 * 4.0 * (2.0 if backward else 1.0)
    hbm = (param_bytes * passes) + slot_bytes + image_bytes

    pixels_per_tile = float(tile_size * tile_size)
    blend_flops = n_isects * pixels_per_tile * 24.0 * passes
    proj_flops = n_gaussians * (300.0 + 2 * sh_bases * 3) * passes
    flops = blend_flops + proj_flops

    hbm_bound_ms = hbm / (peaks["hbm_gbps"] * 1e9) * 1e3
    flop_bound_ms = flops / (peaks["vpu_tflops"] * 1e12) * 1e3
    light = max(hbm_bound_ms, flop_bound_ms)
    return RooflineReport(
        pixels_per_s=n_pixels / (step_ms * 1e-3),
        step_ms=step_ms,
        hbm_bytes_demand=hbm,
        flops_demand=flops,
        hbm_bound_ms=hbm_bound_ms,
        flop_bound_ms=flop_bound_ms,
        light_speed_ms=light,
        fraction_of_light=light / max(step_ms, 1e-9),
    )
