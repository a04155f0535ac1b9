"""The plain reference against cases worked by hand, and against the
port's plain ("torch") route on a small slice of the trained scene."""

from __future__ import annotations

import math

import pytest
import torch

from splatbench.harness import traffic
from splatbench.harness.cells import ref_view
from splatbench.harness.scene import load_scene
from splatbench.reference import render as ref
from splatbench.tests import toy

RULES = ref.Rules.of({"tile_size": 16})
THR = RULES.alpha_threshold


def view(H=32, W=32, f=40.0):
    return ref.View(torch.eye(3), torch.zeros(3), f, f, W / 2, H / 2, H, W, 0.1, 100.0)


def scene(means, log_s, opac, rgb):
    """Raw parameters of isotropic gaussians with SH degree 0 colours."""
    n = len(means)
    op = torch.tensor(opac, dtype=torch.float32).clamp(1e-6, 1 - 1e-6)
    f = (torch.tensor(rgb, dtype=torch.float32) - 0.5) / ref.SH_C0
    return dict(means3d=torch.tensor(means, dtype=torch.float32),
                scales=torch.full((n, 3), math.log(log_s)),
                quats=torch.tensor([[1.0, 0, 0, 0]] * n),
                opacities_raw=torch.log(op / (1 - op)), features=f[:, None, :])


def alpha_at(f, z, s, op, dx, dy):
    """3DGS alpha of an isotropic gaussian at depth z seen face on, at a
    pixel (dx, dy) px from its centre: the 2D variance (f s / z)^2 + 0.3."""
    var = (f * s / z) ** 2 + 0.3
    return min(op * math.exp(-0.5 * (dx * dx + dy * dy) / var), 0.999)


def test_ewa_projection_of_a_face_on_gaussian():
    p = ref.activate(scene([[0.0, 0.0, 2.0]], 0.05, [0.9], [[0.2, 0.4, 0.6]]))
    s = ref.ewa_project(p["means3d"], p["scales"], p["quats"], p["opacities"], view(), RULES)
    var = (40.0 * 0.05 / 2.0) ** 2 + 0.3
    torch.testing.assert_close(s.means2d, torch.tensor([[16.0, 16.0]]))
    torch.testing.assert_close(s.conics, torch.tensor([[1 / var, 0.0, 1 / var]]))
    r = math.ceil(min(math.sqrt(2 * math.log(0.9 / THR)), 3.33) * math.sqrt(var))
    assert s.radii.tolist() == [[r, r]]


def test_one_gaussian_blends_by_the_rule():
    raw = scene([[0.0, 0.0, 2.0]], 0.05, [0.9], [[0.2, 0.4, 0.6]])
    out = ref.render("3dgs", raw, view(), RULES, 0, (0.0, 0.0, 0.0))
    a = alpha_at(40.0, 2.0, 0.05, 0.9, 0.5, 0.5)  # pixel (16, 16): centre (16.5, 16.5)
    torch.testing.assert_close(out.maps["rgb"][16, 16], torch.tensor([0.2, 0.4, 0.6]) * a)
    torch.testing.assert_close(out.maps["T"][16, 16], torch.tensor(1 - a))
    a_far = alpha_at(40.0, 2.0, 0.05, 0.9, 5.5, 0.5)
    assert a_far < THR  # skipped: nothing blended at pixel (21, 16)
    assert float(out.maps["T"][16, 21]) == 1.0
    assert out.pairs == int((out.maps["T"] < 1).sum())


def test_front_to_back_order_and_the_stop():
    front = [[0.0, 0.0, 2.0]]
    raw = scene(front + [[0.0, 0.0, 3.0]], 0.05, [0.5, 0.5], [[1.0, 0, 0], [0, 1.0, 0]])
    out = ref.render("3dgs", raw, view(), RULES, 0, (0.0, 0.0, 0.0))
    a1 = alpha_at(40.0, 2.0, 0.05, 0.5, 0.5, 0.5)
    a2 = alpha_at(40.0, 3.0, 0.05, 0.5, 0.5, 0.5)
    torch.testing.assert_close(out.maps["rgb"][16, 16], torch.tensor([a1, a2 * (1 - a1), 0.0]))
    # Three opaque gaussians: alpha clamps at 0.999; the second would take T
    # to 1e-6 <= 1e-4, so the pixel stops before it.
    raw = scene([[0.0, 0.0, 2.0 + i] for i in range(3)], 1.0, [1.0] * 3,
                [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    out = ref.render("3dgs", raw, view(), RULES, 0, (0.0, 0.0, 0.0))
    torch.testing.assert_close(out.maps["rgb"][16, 16], torch.tensor([0.999, 0.0, 0.0]))
    torch.testing.assert_close(out.maps["T"][16, 16], torch.tensor(1 - 0.999))


def test_binning_lists_every_rectangle_tile_by_depth():
    means2d = torch.tensor([[20.0, 20.0], [20.0, 20.0], [40.0, 8.0]])
    radii = torch.tensor([[5, 5], [9, 3], [0, 0]])
    tiles = ref.bin_tiles(means2d, radii, torch.tensor([2.0, 1.0, 1.0]), 48, 48, 16)
    # gaussian 0: x, y in [15, 25] -> tiles 0..1 each way; gaussian 1: x in
    # [11, 29] -> 0..1, y in [17, 23] -> 1; gaussian 2 is culled.
    per_tile = {t: tiles.ids[tiles.starts[t]:tiles.starts[t + 1]].tolist() for t in range(9)}
    assert per_tile == {0: [0], 1: [0], 2: [], 3: [1, 0], 4: [1, 0], 5: [], 6: [], 7: [], 8: []}
    assert tiles.widest == 2


def test_surfel_alpha_of_a_face_on_disk():
    """A disk facing the camera at depth z, scale s: the pixel ray at
    normalised (xn, yn) meets it at (xn z, yn z), so u = xn z / s."""
    raw = scene([[0.0, 0.0, 2.0]], 0.05, [0.9], [[0.2, 0.4, 0.6]])
    raw["scales"] = raw["scales"][:, :2]
    out = ref.render("2dgs", raw, view(), RULES, 0, (0.0, 0.0, 0.0), maps=True)
    xn = yn = 0.5 / 40.0
    u = v = xn * 2.0 / 0.05
    g = max(math.exp(-0.5 * (u * u + v * v)), math.exp(-(0.25 + 0.25) / (2 * ref.FILTER_SIGMA2)))
    a = min(0.9 * g, 0.999)
    torch.testing.assert_close(out.maps["rgb"][16, 16], torch.tensor([0.2, 0.4, 0.6]) * a)
    torch.testing.assert_close(out.maps["depth"][16, 16], torch.tensor(2.0 * a))
    torch.testing.assert_close(out.maps["normals"][16, 16], torch.tensor([0.0, 0.0, -a]))
    # One surface: alpha m2 - m1^2 = a (a z^2) - (a z)^2 = 0 when a is the alpha sum.
    torch.testing.assert_close(out.maps["distortion"][16, 16],
                               torch.tensor(2.0 * (a * a * 4.0 - (2.0 * a) ** 2)))


def test_sh_colour_matches_the_port():
    from mojosplat_tpu_torch.ops.sh import sh_to_color

    g = torch.Generator().manual_seed(3)
    f = torch.randn(64, 16, 3, generator=g)
    means = torch.randn(64, 3, generator=g)
    cam = torch.tensor([0.3, -1.0, 2.0])
    torch.testing.assert_close(ref.sh_colour(f, means, cam, 3), sh_to_color(f, means, cam, 3))


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(4)
    p0 = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=1e-3)
    mine, p = ref.Adam(1e-3), p0
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p0.items()}
        for k, v in leaves.items():
            v.grad = grads[k].clone()
        opt.step()
        p = mine.step(p, grads)
    for k in p0:
        torch.testing.assert_close(p[k], leaves[k].detach(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
def test_reference_agrees_with_the_ports_plain_route(family):
    """Every 1024th gaussian of the trained scene at 64x96: the image, its
    transmittance, the loss and every parameter's gradient against the
    port's "torch" route."""
    from mojosplat_tpu_torch import RenderConfig, render_gaussians
    from mojosplat_tpu_torch.train import activate, l2_image_loss, surfel_loss

    from splatbench.harness import program

    raw = load_scene(toy.REPO / "assets" / "trained_scene_1m.npz", family, "cpu", every=1024)
    pose = traffic.ring_pose(toy.RING, 70.0, 64, 96)
    v, cam = ref_view(pose, "cpu"), program.camera(pose, "cpu")
    budgets = dict(tile_size=16, max_tile_span=32, tile_capacity=1024, isect_padding_multiplier=16)
    rules = ref.Rules.of(budgets)
    cfg = RenderConfig(raster_impl="torch", **budgets)
    want = ref.render(family, raw, v, rules, 3, (0.0, 0.0, 0.0), maps=family == "2dgs")
    target = want.maps["rgb"] * 0.8 + 0.05
    leaves = {k: t.clone().requires_grad_(True) for k, t in raw.items()}
    p = activate(leaves)
    args = (p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam)
    if family == "3dgs":
        img, aux = render_gaussians(*args, sh_degree=3, config=cfg, return_aux=True)
        loss = l2_image_loss(img, target)
        loss_fn = ref.l2_loss
    else:
        img, aux = __import__("mojosplat_tpu_torch").render_surfels(
            *args, sh_degree=3, config=cfg, return_aux=True)
        loss = surfel_loss(leaves, [cam], target[None], 3, cfg, 0.05, 100.0)
        loss_fn = lambda m, t, vw: ref.surfel_loss(m, t, vw, 0.05, 100.0)  # noqa: E731
    loss.backward()
    assert int(aux.binning.num_isects) == want.num_isects
    for got, exp in ((img, want.maps["rgb"]), (aux.raster.final_transmittance, want.maps["T"])):
        assert float(torch.linalg.norm(got.detach() - exp) / torch.linalg.norm(exp)) < 1e-4
    L, grads, _ = ref.loss_and_grads(family, raw, v, target, rules, 3, loss_fn,
                                     maps=family == "2dgs")
    assert abs(float(L) - float(loss)) < 1e-5 * abs(float(L))
    for k, g in grads.items():
        gap = abs(float(torch.linalg.norm(leaves[k].grad)) - float(torch.linalg.norm(g)))
        assert gap < 1e-4 * float(torch.linalg.norm(g)), k
