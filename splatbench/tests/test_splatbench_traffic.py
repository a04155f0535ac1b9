"""The traffic generator: poses on the ring, and draws that repeat by seed."""

from __future__ import annotations

import json

import numpy as np
import pytest

from splatbench.harness import traffic
from splatbench.tests import toy

SEED = 2**31 + 987_654_321  # larger than 32 signed bits hold


def mix(name):
    return json.loads((toy.REPO / "splatbench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("k", [0, 1, 90, 359, 719])
def test_ring_pose_looks_at_the_target(k):
    m = mix("orbit_1080p")
    p = traffic.pose(m, k)
    R, T = p["R"].astype(np.float64), p["T"].astype(np.float64)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    eye = -R.T @ T
    np.testing.assert_allclose(eye[1], m["ring"]["eye_y"], atol=1e-5)
    np.testing.assert_allclose(np.hypot(eye[0], eye[2]), m["ring"]["radius"], atol=1e-5)
    target = R @ np.asarray(m["ring"]["target"]) + T  # camera frame: on the axis, ahead
    np.testing.assert_allclose(target[:2], 0.0, atol=1e-5)
    assert target[2] > 0
    assert p["fx"] == pytest.approx(0.72 * 1920) and (p["cx"], p["cy"]) == (960, 540)


def test_first_pose_is_the_scenes_evaluation_view():
    from mojosplat_tpu_torch.utils.scenes import scene_camera

    cam = scene_camera(1080, 1920, device="cpu")
    p = traffic.pose(mix("orbit_1080p"), 0)
    np.testing.assert_allclose(p["R"], cam.R.numpy(), atol=1e-6)
    np.testing.assert_allclose(p["T"], cam.T.numpy(), atol=1e-5)


def test_train_views_and_orbit_share_one_grid():
    t, o = mix("train_ring_1080p"), mix("orbit_1080p")
    assert traffic.grid_size(o) == 720
    assert traffic.view_grid_ids(t) == [90 * i for i in range(8)]
    assert set(traffic.all_pose_ids(t)) <= set(traffic.all_pose_ids(o))
    assert traffic.pose_yaw(o, 720) == traffic.pose_yaw(o, 0)


def test_train_order_repeats_by_seed_and_covers_every_view_each_epoch():
    m = mix("train_ring_1080p")
    a, b, c = (traffic.TrainOrder(m, s) for s in (SEED, SEED, SEED + 1))
    seq_a = [a.next() for _ in range(24)]
    assert seq_a == [b.next() for _ in range(24)]
    assert seq_a != [c.next() for _ in range(24)]
    for e in range(3):
        assert sorted(seq_a[8 * e: 8 * e + 8]) == list(range(8))


def test_orbit_start_repeats_by_seed():
    m = mix("orbit_1080p")
    assert traffic.orbit_start(m, SEED) == traffic.orbit_start(m, SEED)
    starts = {traffic.orbit_start(m, SEED + i) for i in range(20)}
    assert len(starts) > 10 and all(0 <= s < 720 for s in starts)
