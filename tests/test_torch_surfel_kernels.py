"""PyTorch port: the plain versions of the surfel blend kernels B6/B7
(``raster_surfel_tiles_plain``) and B8 (``raster_surfel_tiles_bwd_plain``)
against the JAX package's Pallas kernels and their VJP in interpret mode,
on seeded slot tables (``torch_surfel_cases.surfel_pdata``). Split from
tests/test_torch_surfel.py to keep each file under 30 s on one process.

Tolerance: the golden rule of tests/test_golden.py per pdata row, rtol
5e-5 and atol 5e-6 x the row's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu.ops import surfel_pallas as jpallas
from mojosplat_tpu_torch import config_from_jax
from mojosplat_tpu_torch.ops.surfel_cuda import (
    raster_surfel_tiles, raster_surfel_tiles_bwd_plain, raster_surfel_tiles_plain)
from torch_surfel_cases import surfel_pdata

RTOL, ATOL = 5e-5, 5e-6
F32 = np.float32


def assert_rows_close(got, want, err_msg=""):
    """The golden rule per pdata row."""
    for r in range(want.shape[0]):
        scale = float(np.abs(want[r]).max())
        np.testing.assert_allclose(got[r], want[r], rtol=RTOL, atol=ATOL * (scale + 1e-12),
                                   err_msg=f"{err_msg} row {r}")


@pytest.mark.parametrize("aux", [False, True])
def test_plain_kernels_match_pallas(aux):
    rng = np.random.default_rng(20 + aux)
    ts, tw, n_tiles, cap = 16, 2, 4, 64
    pdata = surfel_pdata(rng, n_tiles, tw, ts, cap, aux)
    counts = np.array([0, 19, 64, 50], np.int32)
    oc = 9 if aux else 5
    gout = rng.normal(size=(n_tiles, oc, ts * ts)).astype(F32)
    jcfg = JConfig(tile_size=ts, tile_capacity=cap, chunk_size=32, raster_impl="pallas",
                   pallas_chunk=32, pallas_tiles_per_step=2, pallas_interpret=True)
    out, vjp = jax.vjp(
        lambda pd: jpallas.raster_surfel_tiles_pallas(pd, jnp.asarray(counts), ts, tw, jcfg, aux),
        jnp.asarray(pdata))
    (d_want,) = vjp(jnp.asarray(gout))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    t = torch.from_numpy
    got = raster_surfel_tiles_plain(t(pdata), t(counts), ts, tw, cfg, aux)
    assert got.shape == (n_tiles, oc, ts * ts)
    # The output's rows: the blended channels, the depth moments, T.
    assert_rows_close(got.transpose(0, 1).reshape(oc, -1).numpy(),
                      np.asarray(out).transpose(1, 0, 2).reshape(oc, -1), f"aux={aux} out")
    assert float(got[:, -1].min()) < 0.05  # some pixels are nearly covered
    d_got = raster_surfel_tiles_bwd_plain(t(pdata), t(counts), t(gout), ts, tw, cfg, aux)
    assert d_got.shape == pdata.shape
    assert_rows_close(d_got.numpy(), np.asarray(d_want), f"aux={aux} d pdata")
    # Nothing past each tile's count; the autograd Function gives the same.
    d = d_got.reshape(pdata.shape[0], n_tiles, cap)
    assert torch.all(d[:, 0] == 0) and torch.all(d[:, 1, 19:] == 0)
    pd = t(pdata).requires_grad_(True)
    (raster_surfel_tiles(pd, t(counts), ts, tw, cfg, aux) * t(gout)).sum().backward()
    assert torch.equal(pd.grad, d_got)
