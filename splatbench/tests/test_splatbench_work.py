"""The yardstick's arithmetic: contributing pairs counted by brute force
on a tiny scene, and the bounds, roofline shares and mfu from counts."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from splatbench.metrics import _work
from splatbench.reference import render as ref
from splatbench.tests.test_splatbench_reference import RULES, scene, view


def brute_pairs(raw, v) -> int:
    """Walk every gaussian for every pixel, front to back, by the rule."""
    p = ref.activate(raw)
    s = ref.ewa_project(p["means3d"], p["scales"], p["quats"], p["opacities"], v, RULES)
    order = np.argsort(s.depth.numpy(), kind="stable")
    n = 0
    for y in range(v.H):
        for x in range(v.W):
            T = 1.0
            for g in order:
                if s.radii[g, 0] == 0:
                    continue
                dx, dy = float(s.means2d[g, 0]) - (x + 0.5), float(s.means2d[g, 1]) - (y + 0.5)
                a, b, c = (float(t) for t in s.conics[g])
                sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
                al = min(float(p["opacities"][g]) * math.exp(-sigma), 0.999)
                if sigma < 0 or al < RULES.alpha_threshold:
                    continue
                if T * (1 - al) <= RULES.transmittance_eps:
                    break
                T *= 1 - al
                n += 1
    return n


def test_contributing_pairs_match_a_brute_force_walk():
    g = torch.Generator().manual_seed(5)
    means = (torch.rand(12, 3, generator=g) - 0.5) * torch.tensor([1.2, 1.2, 0.5])
    means[:, 2] += 2.0
    raw = scene(means.tolist(), 0.08, (torch.rand(12, generator=g) * 0.9 + 0.05).tolist(),
                torch.rand(12, 3, generator=g).tolist())
    v = view(H=24, W=40)
    assert ref.render("3dgs", raw, v, RULES, 0, (0.0, 0.0, 0.0)).pairs == brute_pairs(raw, v)


def test_blend_bounds():
    ops, exps, nbytes = _work.blend("3dgs", "fwd", False, pairs=1e8, isects=4e6, pixels=2e6)
    assert (ops, exps) == (25e8, 1e8)
    assert nbytes == 9 * 4 * 4e6 + 4 * 4 * 2e6
    _, _, bwd = _work.blend("3dgs", "bwd", False, pairs=1e8, isects=4e6, pixels=2e6)
    assert bwd == 2 * 9 * 4 * 4e6 + 4 * 4 * 2e6
    assert _work.kernel_bound_s(67e12, 0, 0) == pytest.approx(1.0)
    assert _work.kernel_bound_s(1, _work.SFU_EXP_PER_S * 2, 3.35e12) == pytest.approx(2.0)


def ctx(kind, family, seconds):
    work = [dict(pose=0, units=10, pairs=2e8, isects=4e6, visible=9e5, H=1080, W=1920)]
    return dict(kind=kind, family=family, units=10, window_s=1.0, work=work,
                kernel_seconds=lambda frag: seconds if "bwd" in frag else 0.0)


def test_roofline_share_and_mfu():
    c = ctx("train", "3dgs", 0.05)
    ops, exps, nbytes = _work.blend("3dgs", "bwd", False, 2e8, 4e6, 1080 * 1920)
    want = 100 * 10 * _work.kernel_bound_s(ops, exps, nbytes) / 0.05
    assert _work.kernel_share(c, "3dgs", "train", "bwd", False, "raster_bwd_kernel") == \
        pytest.approx(want)
    # No such kernel ran, or another kind of cell: nothing to read.
    assert _work.kernel_share(c, "3dgs", "train", "fwd", False, "raster_fwd_kernel") is None
    assert _work.kernel_share(c, "2dgs", "train", "bwd", True, "surfel_bwd_kernel") is None
    step = _work.unit_bound_s("3dgs", True, c["work"][0])
    assert _work.mfu(c, "train") == pytest.approx(100 * 10 * step)
    assert _work.mfu(c, "orbit") is None
    assert _work.unit_bound_s("3dgs", False, c["work"][0]) < step
