"""PyTorch port: the blend-variant probe (B9) against the reference's body.

``scripts/dev_kernel_probe.py`` cannot be imported: its module level builds
a 1M-gaussian scene and calls Pallas without ``interpret``. So its kernel
body ``_variant_kernel`` and its entry ``run_variant`` are taken from the
source with ``ast`` and executed in a namespace that supplies the
module-level names they read (``cfg``, ``ts``, ``tw``, ``P``, ``tps`` = 1,
``K``) at a small size, the helpers of ``raster_pallas``, and
``pl.pallas_call`` with ``interpret=True``.

On the CPU, JAX computes DEFAULT-precision dots in f32, where the TPU's
matrix unit rounds both operands to bf16 in one pass. The namespace's
``jax`` therefore carries a ``lax.dot_general`` that rounds both operands
to bf16 when the precision is DEFAULT (the ``blend1`` and ``blend3``
variants); HIGHEST passes through.

Tolerances: the B1 rule (at most 0.01% of values off by more than 1e-5 of
the output row's scale, none by more than 5e-3 of it) for every variant
with the transmittance chain; 1e-6 of the row's scale for ``blend`` and
``memonly``, whose raw row sums run in another order. ``blend1`` and
``blend3`` round each weight to bf16, which turns a one-ulp f32 difference
in the weight (the port walks the kernel's serial transmittance, the
reference a chunked cumprod) into a step of 2^-8 of that product: they
keep the B1 rule's maximum, with at most 0.5% of values off by more than
1e-5 (readings: 4 of 5120, max 3.1e-5 of the scale). The three-pass
product moves the image by less than 1e-5 of the scale, so each is also
held to be at least four times closer to the reference's variant than
that variant is to ``full`` (the L1 norm over the output; readings 3e-5 to
1e-4 of it for ``blend1``, 0.05 to 0.08 for ``blend3``). ``full`` is the
port's B1 plain version exactly.
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu.ops import raster_pallas
from mojosplat_tpu_torch import RenderConfig
from mojosplat_tpu_torch.ops.raster_cuda import raster_tiles_plain
from mojosplat_tpu_torch.ops.raster_probe import (
    VARIANTS, raster_variant, raster_variant_plain)

PROBE = Path(__file__).resolve().parent.parent / "scripts" / "dev_kernel_probe.py"
TS, TW, N_TILES, CAP, K = 16, 2, 4, 64, 32
COUNTS = np.array([0, 17, 40, 64], np.int32)
SUM_VARIANTS = ("blend", "memonly")
BF16_VARIANTS, BF16_MAX_SHARE, BF16_MAX_L1_RATIO = ("blend1", "blend3"), 5e-3, 0.25


def _bf16_lax():
    """``jax.lax`` with a dot_general that takes DEFAULT precision as one
    bf16 pass: both operands rounded to bf16, products summed in f32."""
    def dot_general(lhs, rhs, dims, precision=None, **kw):
        if precision == jax.lax.Precision.DEFAULT:
            lhs = lhs.astype(jnp.bfloat16).astype(jnp.float32)
            rhs = rhs.astype(jnp.bfloat16).astype(jnp.float32)
        return jax.lax.dot_general(lhs, rhs, dims, precision=precision, **kw)

    lax = types.SimpleNamespace(**{k: getattr(jax.lax, k) for k in dir(jax.lax)
                                   if not k.startswith("__")})
    lax.dot_general = dot_general
    return lax


@functools.cache
def reference_run_variant():
    """``run_variant`` of the reference probe, compiled from its source
    into a namespace at this test's size."""
    tree = ast.parse(PROBE.read_text())
    wanted = [node for node in tree.body
              if isinstance(node, ast.FunctionDef)
              and node.name in ("_variant_kernel", "run_variant")]
    assert len(wanted) == 2
    shim_jax = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                        if not k.startswith("__")})
    shim_jax.lax = _bf16_lax()
    shim_pl = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                       if not k.startswith("__")})
    shim_pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(
        jax=shim_jax, jnp=jnp, pl=shim_pl, pltpu=pltpu, functools=functools,
        cfg=JConfig(tile_capacity=CAP, chunk_size=K, pallas_chunk=K),
        ts=TS, tw=TW, P=TS * TS, tps=1, K=K,
        **{name: getattr(raster_pallas, name) for name in (
            "_chunk_rows", "_lane_col", "_lane_cumprod", "_lane_excl",
            "_tile_pixel_centers")},
    )
    exec(compile(ast.Module(body=wanted, type_ignores=[]), str(PROBE), "exec"), ns)
    return jax.jit(ns["run_variant"], static_argnums=0)


def probe_pdata(seed=0, cp=4):
    """(6 + cp, N_TILES * CAP) slot rows: centres within 4 px of their tile,
    random positive-definite conics, opacities up to 0.99 (some below the
    threshold), channels in [0, 1.5)."""
    rng = np.random.default_rng(seed)
    m = N_TILES * CAP
    tile = np.repeat(np.arange(N_TILES), CAP)
    sx, sy = rng.uniform(0.5, 8.0, m), rng.uniform(0.5, 8.0, m)
    rho = rng.uniform(-0.8, 0.8, m)
    det = (sx * sy) ** 2 * (1 - rho**2)
    opac = rng.uniform(0.0, 0.99, m)
    opac[rng.random(m) < 0.05] = 1.0 / 255.0 * 0.5
    rows = [(tile % TW) * TS + rng.uniform(-4, TS + 4, m),
            (tile // TW) * TS + rng.uniform(-4, TS + 4, m),
            sy**2 / det, -rho * sx * sy / det, sx**2 / det, opac]
    rows += [rng.uniform(0, 1.5, m) for _ in range(cp)]
    return np.stack(rows).astype(np.float32)


def held_to(variant, got, want):
    """Per output row (channels, then T), scale = the row's largest |want|."""
    scale = np.abs(want).max(axis=(0, 2), keepdims=True).clip(min=1e-30)
    diff = np.abs(got - want) / scale
    if variant in SUM_VARIANTS:
        assert diff.max() <= 1e-6, (variant, diff.max())
    else:
        share = BF16_MAX_SHARE if variant in BF16_VARIANTS else 1e-4
        assert (diff > 1e-5).sum() <= share * diff.size, (variant, (diff > 1e-5).sum())
        assert diff.max() <= 5e-3, (variant, diff.max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_probe_plain_matches_reference_body(variant):
    pdata = probe_pdata()
    run_variant = reference_run_variant()
    want = np.asarray(run_variant(variant, jnp.asarray(pdata), jnp.asarray(COUNTS)))
    cfg = RenderConfig(tile_size=TS, tile_capacity=CAP, chunk_size=K)
    got = raster_variant_plain(variant, torch.from_numpy(pdata), torch.from_numpy(COUNTS),
                               TS, TW, cfg, chunk=K).numpy()
    assert got.shape == want.shape == (N_TILES, 5, TS * TS)
    held_to(variant, got, want)
    if variant in BF16_VARIANTS:
        full = np.asarray(run_variant("full", jnp.asarray(pdata), jnp.asarray(COUNTS)))
        ratio = np.abs(got - want).sum() / np.abs(want - full).sum()
        assert ratio <= BF16_MAX_L1_RATIO, (variant, ratio)
    # On a CPU tensor the wrapper is the plain version.
    wrapped = raster_variant(variant, torch.from_numpy(pdata), torch.from_numpy(COUNTS),
                             TS, TW, cfg, chunk=K)
    assert np.array_equal(wrapped.numpy(), got)
    if variant == "full":
        b1 = raster_tiles_plain(torch.from_numpy(pdata), torch.from_numpy(COUNTS), TS, TW, cfg)
        assert np.array_equal(b1.numpy(), got)
    # An empty tile reads nothing: zero channels and T = 1.
    assert np.all(got[0, :4] == 0) and np.all(got[0, 4] == 1)


def test_probe_fast_paths_move_the_image():
    """The bf16 products move the image (the shim takes effect), blend3 by
    less than blend1, on both sides alike."""
    pdata = probe_pdata(seed=1)
    run_variant = reference_run_variant()
    args = (jnp.asarray(pdata), jnp.asarray(COUNTS))
    full = np.asarray(run_variant("full", *args))
    d1 = np.abs(np.asarray(run_variant("blend1", *args)) - full).max()
    d3 = np.abs(np.asarray(run_variant("blend3", *args)) - full).max()
    assert d1 > 1e-4 and d3 < d1 / 10
    cfg = RenderConfig(tile_size=TS, tile_capacity=CAP)
    t = (torch.from_numpy(pdata), torch.from_numpy(COUNTS), TS, TW, cfg)
    port = {v: raster_variant_plain(v, *t, chunk=K) for v in ("full", "blend1", "blend3")}
    np.testing.assert_allclose((port["blend1"] - port["full"]).abs().max(), d1, rtol=0.1)
    assert float((port["blend3"] - port["full"]).abs().max()) < d1 / 10


def test_probe_rejects_what_it_does_not_take():
    pdata = torch.from_numpy(probe_pdata())
    counts = torch.from_numpy(COUNTS)
    cfg = RenderConfig(tile_size=TS, tile_capacity=CAP)
    with pytest.raises(ValueError):
        raster_variant("nosuch", pdata, counts, TS, TW, cfg, chunk=K)
    with pytest.raises(ValueError):  # the chunk must divide the tile capacity
        raster_variant("noscan", pdata, counts, TS, TW, cfg, chunk=48)
    with pytest.raises(ValueError):  # and hold at least the channels
        raster_variant("memonly", pdata, counts, TS, TW, cfg, chunk=2)
