"""PyTorch port: the ``train_colmap`` CLI's step loss against the JAX
package, with the default SSIM weight (0.2).

The step loss of tests/test_torch_train_colmap_cli.py at step 0 (the view
parameters at identity, view 0) with the D-SSIM term. The SSIM's variance
blur(x^2) - mx^2 cancels on the capture's smooth regions, and the two
packages' f32 convolutions, which sum in different orders (torch's on the
CPU lands 2-3x farther from float64 than XLA's), move the gradients by up
to 6e-6 of their scale. So both packages also compute the loss in
float64 (the port's ``"torch"`` route; the JAX package under
``jax.enable_x64``), each with the SSIM window computed in float64 (both
compute it in f32, through exponentials an ulp apart): the port's float64
loss and gradients must lie within F64_RTOL of the scale of the
reference's, and its f32 ones within the golden tolerance (rtol 5e-5, atol
5e-6 x max|g|), plus the reference's own largest f32 distance from its
float64 value, of both the reference's f32 and float64 values (the rule of
tests/torch_camera_cases.py).
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from mojosplat_tpu import train as jtrain
from mojosplat_tpu_torch import train as ttrain
from torch_colmap_cases import train_capture
from torch_step_loss_cases import StepLoss, tree_leaves

RTOL, ATOL, F64_RTOL = 5e-5, 5e-6, 1e-12
SSIM_WEIGHT = 0.2


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return StepLoss(train_capture(tmp_path_factory.mktemp("capture")))


def test_step_loss_with_ssim_matches_jax(case, monkeypatch):
    assert case.args.ssim_weight == SSIM_WEIGHT  # the CLI's default
    g = np.exp(-(np.arange(11.0) - 5.0) ** 2 / 4.5)  # the SSIM window, sigma 1.5
    g /= g.sum()
    want32 = case.jax(case.identity, 0, SSIM_WEIGHT)
    got32 = case.port(case.identity, 0, SSIM_WEIGHT)
    with monkeypatch.context() as m:
        m.setattr(jtrain, "_gaussian_window", lambda *a: jnp.asarray(np.outer(g, g)))
        m.setattr(ttrain, "_gaussian_window", lambda *a: torch.from_numpy(g))
        want64 = case.jax(case.identity, 0, SSIM_WEIGHT, np.float64)
        got64 = case.port(case.identity, 0, SSIM_WEIGHT, torch.float64)
    for (path, g32), (_, g64), (_, w32), (_, w64) in tree_leaves(got32, got64, want32, want64):
        what = jax.tree_util.keystr(path)
        scale = float(np.abs(w64).max())
        assert float(np.abs(g64 - w64).max()) <= F64_RTOL * scale, what
        slack = ATOL * scale + float(np.abs(w32 - w64).max())
        for other in (w32, w64):
            np.testing.assert_allclose(g32, other, rtol=RTOL, atol=slack, err_msg=what)
