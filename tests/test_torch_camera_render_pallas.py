"""PyTorch port: a render through a rolling-shutter fisheye camera and a
pose delta, both port routes against the JAX package's "pallas" route in
interpret mode. The body and its tolerances are in
tests/torch_camera_cases.py; the "xla" route's cases are in
tests/test_torch_camera_render.py.
"""

import pytest

from torch_camera_cases import check_render


@pytest.mark.parametrize("kind,impl", [("rolling-fisheye", "pallas")])
def test_render_matches_jax(kind, impl):
    check_render(kind, impl)
