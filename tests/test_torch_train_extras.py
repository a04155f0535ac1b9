"""PyTorch port: the appearance modules, the sparse depth loss and the
checkpoint against the JAX package.

``bilagrid`` (``identity_bilateral_grid``, ``apply_bilateral_grid``,
``bilateral_grid_tv``) and, from ``train``, ``apply_exposure``,
``identity_exposure`` and ``sparse_depth_loss``: forward values and the
``jax.vjp`` gradients of every input for a seeded cotangent, at the golden
tolerance of tests/test_torch_train.py (rtol 5e-5, atol 5e-6 x max|g|).
The grid is resized to images whose sizes are not multiples of it (37x53,
48x64) and to one smaller than it (8x5, where the resize averages), and
the images hold black and white pixels, whose lumas sit on the clip's ends
and on guidance bins, where the clip, |x| and the hat's max take their
kinks' gradients.
``utils.checkpoint``: a training state saved and restored bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojosplat_tpu import bilagrid as jbilagrid
from mojosplat_tpu import train as jtrain
from mojosplat_tpu_torch import bilagrid, densify
from mojosplat_tpu_torch import train as ttrain
from mojosplat_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from torch_colmap_cases import assert_state_equal

RTOL, ATOL = 5e-5, 5e-6


def assert_close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * (float(np.abs(want).max())
                                                                  + 1e-12), err_msg=err_msg)


def check_vjp(fn, jfn, inputs, seed=0):
    """fn(*tensors) against jfn(*arrays): the value, and each float input's
    gradient for one seeded cotangent."""
    want, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(a) for a in inputs))
    leaves = [torch.from_numpy(np.array(a)) for a in inputs]
    for t in leaves:
        t.requires_grad_(t.is_floating_point())
    got = fn(*leaves)
    assert_close(got.detach().numpy(), want, "value")
    ct = np.random.default_rng(seed).normal(size=np.shape(want)).astype(np.float32)
    got.backward(torch.from_numpy(ct))
    jgrads = vjp(jnp.asarray(ct))
    for j, (t, jg) in enumerate(zip(leaves, jgrads)):
        if t.is_floating_point():
            if t.grad is None:  # no path to the value (the rounded coordinates)
                assert not np.asarray(jg).any(), f"d input {j}"
            else:
                assert_close(t.grad.numpy(), jg, f"d input {j}")


def image_with_kinks(H, W, seed):
    """A seeded RGB image with black pixels (luma 0: the clip's lower end
    and guidance bin 0), white ones (luma 1: its upper end and the last
    bin) and an over-exposed one (clipped)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    img[0, :3] = 0.0
    img[-1, -3:] = 1.0
    img[3, 0] = 2.0  # over-exposed: luma clipped
    return img


@pytest.mark.parametrize("H,W", [(37, 53), (48, 64), (8, 5)])
def test_apply_bilateral_grid_matches_jax(H, W):
    gd = 8
    rng = np.random.default_rng(H)
    grid = np.asarray(jbilagrid.identity_bilateral_grid(1, (16, 12, gd))[0])
    grid = (grid + rng.normal(0, 0.05, grid.shape)).astype(np.float32)
    img = image_with_kinks(H, W, H + W)
    check_vjp(bilagrid.apply_bilateral_grid, jbilagrid.apply_bilateral_grid, [img, grid])
    # Black pixels (luma 0, on bin 0) through the identity grid stay black.
    ident = bilagrid.identity_bilateral_grid(1, (16, 12, gd), device="cpu")[0]
    out = bilagrid.apply_bilateral_grid(torch.from_numpy(img), ident)
    assert not out[0, :3].any()


def test_bilateral_grid_identity_and_tv_match_jax():
    for n, shape in ((3, (16, 16, 8)), (1, (4, 6, 3))):
        got = bilagrid.identity_bilateral_grid(n, shape, device="cpu")
        want = np.asarray(jbilagrid.identity_bilateral_grid(n, shape))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    grids = np.random.default_rng(0).normal(size=(2, 5, 4, 3, 12)).astype(np.float32)
    check_vjp(bilagrid.bilateral_grid_tv, jbilagrid.bilateral_grid_tv, [grids])
    check_vjp(bilagrid.bilateral_grid_tv, jbilagrid.bilateral_grid_tv, [grids[0]])


def test_exposure_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (21, 34, 3)).astype(np.float32)
    affine = (np.eye(3, 4) + rng.normal(0, 0.1, (3, 4))).astype(np.float32)
    check_vjp(ttrain.apply_exposure, jtrain.apply_exposure, [img, affine])
    got = ttrain.identity_exposure(4, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtrain.identity_exposure(4)))
    ident = torch.from_numpy(img)
    assert torch.equal(ttrain.apply_exposure(ident, got[0]), ident)


def test_sparse_depth_loss_matches_jax():
    H, W, K = 24, 31, 64
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    depth[:4] = 0.0  # uncovered rows: the select-free disparity stays finite
    alpha = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    alpha[:4] = 0.0
    uv = np.stack([rng.uniform(-3, W + 3, K), rng.uniform(-3, H + 3, K)], -1).astype(np.float32)
    uv[:6] = [[2.5, 5.5], [3.5, 6.5], [-0.5, 0.5], [W - 0.5, H - 0.5], [10.5, 2.0], [4.0, 1.5]]
    depth_gt = rng.uniform(0.5, 4.0, K).astype(np.float32)
    mask = rng.uniform(size=K) < 0.8
    check_vjp(ttrain.sparse_depth_loss, jtrain.sparse_depth_loss,
              [depth, alpha, uv, depth_gt, mask])
    none = ttrain.sparse_depth_loss(*(torch.from_numpy(a) for a in
                                      (depth, alpha, uv, depth_gt, np.zeros(K, bool))))
    assert float(none) == 0.0


def test_checkpoint_restores_bit_equal(tmp_path):
    gen = torch.Generator().manual_seed(3)
    params = {k: v.requires_grad_(True) for k, v in ttrain.init_gaussians(
        32, sh_degree=1, generator=gen, device="cpu").items()}
    opt = ttrain.make_optimizer(params, 1e-3)
    view = {"pose": torch.zeros(2, 6, requires_grad=True),
            "bgrid": bilagrid.identity_bilateral_grid(2, (4, 4, 2), device="cpu")}
    view["bgrid"].requires_grad_(True)
    vopt = ttrain.selective_adam([{"params": [view["pose"]], "lr": 1e-4},
                                  {"params": [view["bgrid"]], "lr": 2e-3}])
    for _ in range(2):
        loss = sum((v.float() ** 2).sum() for v in params.values()) + view["pose"][0].sum() \
            + view["bgrid"][1].square().sum()
        loss.backward()
        opt.step()
        vopt.step()
    dstate = densify.DensifyState(torch.rand(32, generator=gen),
                                  torch.arange(32, dtype=torch.int32))
    state = dict(step=7, params={k: v.detach() for k, v in params.items()},
                 adam=opt.state_dict(), view_params={k: v.detach() for k, v in view.items()},
                 view_adam=vopt.state_dict(), dstate=dstate._asdict(),
                 generator=gen.get_state())
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    assert not (tmp_path / "ckpt.tmp").exists()
    back = restore_checkpoint(path)
    assert_state_equal(back, state)
    # The generator resumes its sequence, the optimizers their moments.
    gen2 = torch.Generator()
    gen2.set_state(back["generator"])
    assert torch.equal(torch.rand(5, generator=gen2), torch.rand(5, generator=gen))
    opt2 = ttrain.make_optimizer({k: v.clone().requires_grad_(True)
                                  for k, v in back["params"].items()}, 1e-3)
    opt2.load_state_dict(back["adam"])
    assert_state_equal(opt2.state_dict(), opt.state_dict())
