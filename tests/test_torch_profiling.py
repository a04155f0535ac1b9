"""PyTorch port: ``utils.profiling`` and ``utils.metrics`` against the
reference's ``mojosplat_tpu.utils.profiling`` / ``metrics``.

The roofline demand and bound fields must equal the reference's at
``chip="cpu"`` over a few shapes, with and without backward; the H100 peaks
are the data sheet's. ``log_render_aux`` on a port ``RenderAux`` must
return the reference's dict for the same counters (and warn on an
overflow as it does). ``StageTimer`` as tests/test_utils.py drives it;
``trace`` writes a Chrome trace holding an ``annotate`` label;
``amortized_ms`` is positive and finite; ``compilation_count`` stays 0 on
the CPU, where no kernel is built.
"""

import json
import logging
import math
import time

import jax.numpy as jnp
import pytest
import torch

from mojosplat_tpu.ops.binning import BinningAux as JBinningAux
from mojosplat_tpu.ops.rasterization import RasterAux as JRasterAux
from mojosplat_tpu.render import RenderAux as JRenderAux
from mojosplat_tpu.utils import metrics as jmetrics
from mojosplat_tpu.utils import profiling as jprofiling
from mojosplat_tpu_torch import RenderConfig, render_gaussians
from mojosplat_tpu_torch.ops.binning import BinningAux
from mojosplat_tpu_torch.ops.rasterization import RasterAux
from mojosplat_tpu_torch.render import RenderAux
from mojosplat_tpu_torch.utils import (
    StageTimer,
    amortized_ms,
    annotate,
    compilation_count,
    log_render_aux,
    roofline_report,
    trace,
)
from mojosplat_tpu_torch.utils.profiling import CHIP_PEAKS

SHAPES = [
    dict(step_ms=182.0, n_pixels=1920 * 1080, n_isects=4_000_000, n_gaussians=1_000_000),
    dict(step_ms=10.0, n_pixels=800 * 600, n_isects=500_000, n_gaussians=100_000,
         sh_bases=4, tile_size=32),
    dict(step_ms=0.5, n_pixels=1000, n_isects=1000, n_gaussians=1000, sh_bases=1),
]


@pytest.mark.parametrize("backward", [True, False])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_roofline_matches_reference(shape, backward):
    kw = dict(SHAPES[shape], backward=backward, chip="cpu")
    got, want = roofline_report(**kw), jprofiling.roofline_report(**kw)
    for field in ("pixels_per_s", "step_ms", "hbm_bytes_demand", "flops_demand",
                  "hbm_bound_ms", "flop_bound_ms", "light_speed_ms", "fraction_of_light"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.as_dict() == want.as_dict()


def test_roofline_h100_default():
    assert set(CHIP_PEAKS) == {"h100", "cpu"}
    assert CHIP_PEAKS["h100"] == {"bf16_tflops": 989.0, "vpu_tflops": 67.0,
                                  "hbm_gbps": 3350.0}
    r = roofline_report(step_ms=182.0, n_pixels=1920 * 1080, n_isects=4_000_000,
                        n_gaussians=1_000_000)
    assert r.hbm_bound_ms == pytest.approx(r.hbm_bytes_demand / 3.35e12 * 1e3)
    assert r.flop_bound_ms == pytest.approx(r.flops_demand / 67e12 * 1e3)
    assert 0.0 < r.fraction_of_light <= 1.0


def aux_pair(overflow: int):
    counters = dict(num_isects=10, capacity_overflow=overflow, span_truncated=2,
                    tight_culled=0)
    port = RenderAux(
        binning=BinningAux(**{k: torch.tensor(v, dtype=torch.int32)
                              for k, v in counters.items()}),
        raster=RasterAux(final_transmittance=torch.ones((4, 4)),
                         tile_overflow=torch.tensor(3, dtype=torch.int32)))
    ref = JRenderAux(
        binning=JBinningAux(**{k: jnp.int32(v) for k, v in counters.items()}),
        raster=JRasterAux(final_transmittance=jnp.ones((4, 4)), tile_overflow=jnp.int32(3)))
    return port, ref


@pytest.mark.parametrize("overflow", [0, 5])
def test_log_render_aux_matches_reference(overflow, caplog):
    port, ref = aux_pair(overflow)
    with caplog.at_level(logging.DEBUG):
        got = log_render_aux(port, step=3)
        want = jmetrics.log_render_aux(ref, step=3)
    assert got == want
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert [r.name for r in warnings] == (["mojosplat_tpu_torch", "mojosplat_tpu"]
                                          if got["tile_capacity_overflow"] else [])


def test_stage_timer():
    t = StageTimer()
    x = torch.ones((8, 8))
    for _ in range(3):
        t.time_fn("double", lambda a: a * 2, x)
    holder = []
    with t.stage("sum", holder):
        holder.append(torch.sum(x))
    s = t.summary()
    assert s["double"]["count"] == 3 and s["sum"]["count"] == 1
    assert s["double"]["mean_ms"] >= 0 and s["double"]["min_ms"] <= s["double"]["max_ms"]


def test_trace_writes_annotated_trace(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir), device="cpu"):
        with annotate("tiny-step"):
            (torch.ones((64, 64)) * 2 + 1).sum()
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "tiny-step" for e in events)


def test_amortized_ms_positive():
    ms = amortized_ms(lambda a, b: a @ b, (torch.ones((64, 64)), torch.ones((64, 64))), 5)
    assert math.isfinite(ms) and ms > 0


def test_amortized_ms_stall_in_the_single_call():
    """A stall in the one-call reading, longer than the ``iters`` calls
    together, gives their mean, not 0.0."""
    calls = []

    def fn(x):
        calls.append(None)
        time.sleep(0.2 if len(calls) == 2 else 0.002)  # call 2: the one-call reading
        return x

    ms = amortized_ms(fn, (torch.ones(4),), 3)
    assert len(calls) == 5
    assert 2 <= ms < 100


def test_compilation_count_zero_on_cpu():
    """Both routes on CPU tensors build no kernel (the "cuda" route runs
    the plain versions there)."""
    from mojosplat_tpu_torch import Camera

    n = 16
    gen = torch.Generator().manual_seed(0)
    means = torch.randn((n, 3), generator=gen) * 0.3 + torch.tensor([0.0, 0.0, 3.0])
    cam = Camera.create(R=torch.eye(3), T=torch.zeros(3), H=32, W=48, fx=40.0, fy=40.0,
                        cx=24.0, cy=16.0, device="cpu")
    for impl in ("torch", "cuda"):
        render_gaussians(means, torch.full((n, 3), -2.0), torch.tensor([[1.0, 0, 0, 0]] * n),
                         torch.full((n,), 0.8), torch.rand((n, 3), generator=gen), cam,
                         config=RenderConfig(raster_impl=impl))
    assert compilation_count() == 0
