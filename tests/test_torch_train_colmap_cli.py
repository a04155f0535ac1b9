"""PyTorch port: the ``train_colmap`` CLI's step loss against the JAX
package, with the L1 photometric loss.

``mojosplat_tpu_torch.examples.train_colmap.step_loss`` with ``--strategy
none --depth-loss --pose-opt --exposure-opt --bilagrid --intrinsics-opt
--ssim-weight 0`` on the ``"torch"`` route: the loss and every gradient, of
the gaussians and of each view group, against ``jax.value_and_grad`` of the
same loss composed from the JAX package as ``examples/train_colmap.py``'s
``loss_fn`` composes it (``"xla"`` route; ``torch_step_loss_cases.StepLoss``),
at step 0 (the view parameters at identity, view 0) and at a seeded state
off identity (view 1), at the golden tolerance of
tests/test_torch_train.py: rtol 5e-5 and atol 5e-6 x max|g|. The default
SSIM weight is held to JAX in tests/test_torch_train_colmap_cli_f64.py.
The capture is tests/test_train_colmap_cli.py's.
"""

import jax
import numpy as np
import pytest

from torch_colmap_cases import train_capture
from torch_step_loss_cases import StepLoss, tree_leaves

RTOL, ATOL = 5e-5, 5e-6


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return StepLoss(train_capture(tmp_path_factory.mktemp("capture")))


@pytest.mark.parametrize("state,view", [("identity", 0), ("moved", 1)])
def test_step_loss_matches_jax(case, state, view):
    vp = getattr(case, state)
    got, want = case.port(vp, view, 0.0), case.jax(vp, view, 0.0)
    for (path, g), (_, w) in tree_leaves(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * float(np.abs(w).max()),
                                   err_msg=f"{state}, view {view}: {jax.tree_util.keystr(path)}")
    for k, g in got[1][1].items():  # only the rendered view's row has a gradient
        assert not g[1 - view].any() and np.abs(g[view]).max() > 0, k
